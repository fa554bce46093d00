"""Quickstart: the paper's listing 1, an intensity-inverting filter, on the
port (the walkthrough of the JAX package's ``examples/quickstart.py``).

    python -m repro_torch.launch.quickstart        (with src/ on PYTHONPATH)

Steps: get an app and select the device (the CUDA card; the CPU only when
the caller hands in a CPU app), load the ``negate`` kernel module in one
call, make a synthetic 256x256 "Cameraman" stand-in, declare the operator
graph ``Pipeline(app) | Negate(app).bind(...)``, run it 10 times with
profiling (on the card the second run captures the launch into a CUDA
graph and every later run replays it), and check the result against
``1 - x`` bit for bit.  Reading and
writing image files is left to a later slice (``Data.save``/``load``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core import CLapp, Pipeline, ProfileParameters, XData
from repro_torch.processes import Negate


def synthetic_image(n: int = 256) -> np.ndarray:
    """The quickstart's smooth n x n test image in [0, 1], f32."""
    yy, xx = np.mgrid[0:n, 0:n]
    return (np.sin(xx / 17.0) * np.cos(yy / 11.0) * 0.5 + 0.5).astype(np.float32)


def run(app: Optional[CLapp] = None, runs: int = 10) -> dict:
    """The walkthrough; returns the output image, the mean launch time and
    each profiled run's (on the card the first of them captures the
    graph), the graph's captures and replays, and the device it ran on.
    Raises if the output is not ``1 - x``."""
    # Steps 0-1: a new app; the default traits select the CUDA card
    if app is None:
        app = CLapp().init()
    # Step 2: load the kernel module: one call, indexed by name
    app.loadKernels("negate")
    # Step 3: input data
    img = synthetic_image()
    data_in = XData({"img": img})
    # Step 4: declare the operator graph; ports are checked and the output
    # Data is allocated from inferred specs at the first run
    pipe = Pipeline(app) | Negate(app).bind()
    # Step 5: run, repeatedly, against the one built graph
    prof = ProfileParameters(enable=True)
    data_out = pipe.run(data_in)
    for _ in range(runs):
        data_out = pipe.run(data_in, profile=prof)
    # Step 6: the result is synced to the host (sync=True); check it
    got = data_out.get_ndarray(0).host
    np.testing.assert_array_equal(got, 1.0 - img)
    negate = pipe.build().executor          # on the card, replayed from its second run
    return {"image": got, "mean_launch_s": float(np.mean(prof.samples)),
            "launch_s": list(prof.samples), "runs": runs, "device": str(app.device),
            "captures": negate.captures, "replays": negate.replays}


def main() -> None:
    res = run()
    print(f"negate on {res['device']}: mean launch time over {res['runs']} runs "
          f"{res['mean_launch_s'] * 1e6:.1f} us; output verified against 1 - x")


if __name__ == "__main__":
    main()
