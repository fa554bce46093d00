"""Quickstart: the paper's listing 1, an intensity-inverting filter, on the
port (the walkthrough of the JAX package's ``examples/quickstart.py``).

    python -m repro_torch.launch.quickstart [input.png] [output.png]
    (with src/ on PYTHONPATH)

Steps: get an app and select the device (the CUDA card; the CPU only when
the caller hands in a CPU app), load the ``negate`` kernel module in one
call, read the input image (an 8-bit gray png or pgm, scaled to [0, 1]
f32; without a path, a synthetic 256x256 "Cameraman" stand-in), declare
the operator graph ``Pipeline(app) | Negate(app).bind(...)``, run it 10
times with profiling (on the card the second run captures the launch into
a CUDA graph and every later run replays it), check the result against
``1 - x`` bit for bit, and write it to the output image (default
``output.png``; a float image is stored as 8 bits).
"""
from __future__ import annotations

import sys
from typing import Optional

import numpy as np

from repro_torch.core import CLapp, Pipeline, ProfileParameters, SyncSource, XData
from repro_torch.processes import Negate


def synthetic_image(n: int = 256) -> np.ndarray:
    """The quickstart's smooth n x n test image in [0, 1], f32."""
    yy, xx = np.mgrid[0:n, 0:n]
    return (np.sin(xx / 17.0) * np.cos(yy / 11.0) * 0.5 + 0.5).astype(np.float32)


def run(app: Optional[CLapp] = None, runs: int = 10, in_path: Optional[str] = None,
        out_path: Optional[str] = None) -> dict:
    """The walkthrough; returns the output image, the mean launch time and
    each profiled run's (on the card the first of them captures the
    graph), the graph's captures and replays, the device it ran on and the
    path it wrote (``out_path``, default ``output.png``).  Raises if the
    output is not ``1 - x``."""
    # Steps 0-1: a new app; the default traits select the CUDA card
    if app is None:
        app = CLapp().init()
    # Step 2: load the kernel module: one call, indexed by name
    app.loadKernels("negate")
    # Step 3: input data, from an 8-bit image file or made here
    if in_path:
        data_in = XData(in_path, dtype=np.float32)
        arr = data_in.get_ndarray(0)
        arr.set_host(arr.host / np.float32(255.0))
    else:
        data_in = XData({"img": synthetic_image()})
    img = data_in.get_ndarray(0).host
    # Step 4: declare the operator graph; ports are checked and the output
    # Data is allocated from inferred specs at the first run
    pipe = Pipeline(app) | Negate(app).bind()
    # Step 5: run, repeatedly, against the one built graph
    prof = ProfileParameters(enable=True)
    data_out = pipe.run(data_in)
    for _ in range(runs):
        data_out = pipe.run(data_in, profile=prof)
    # Step 6: the result is synced to the host (sync=True); check and save it
    got = data_out.get_ndarray(0).host
    np.testing.assert_array_equal(got, 1.0 - img)
    out_path = out_path or "output.png"
    data_out.save(out_path, SyncSource.HOST_ONLY)
    negate = pipe.build().executor          # on the card, replayed from its second run
    return {"image": got, "mean_launch_s": prof.mean(),
            "launch_s": list(prof.samples), "runs": runs, "device": str(app.device),
            "captures": negate.captures, "replays": negate.replays, "out_path": out_path}


def main(argv: Optional[list] = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    res = run(in_path=argv[0] if argv else None, out_path=argv[1] if len(argv) > 1 else None)
    print(f"negate on {res['device']}: mean launch time over {res['runs']} runs "
          f"{res['mean_launch_s'] * 1e6:.1f} us; output verified against 1 - x; "
          f"wrote {res['out_path']}")


if __name__ == "__main__":
    main()
