"""The port's arena against the JAX package's: same offsets, same bytes.

Arena bytes are compared exactly (the format is shared); round trips and
``interop`` take-overs are compared exactly too.
"""
import numpy as np
import pytest
import torch

from repro.core import arena as jarena
from repro_torch import interop
from repro_torch.core import arena as tarena
from repro_torch.core import CLapp, DeviceTraits, DeviceType, KData, PlatformTraits, XData


def _mixed(rng):
    """Mixed dtypes and odd shapes, including a 0-d scalar and a 1-byte entry."""
    return {
        "kdata": (rng.standard_normal((2, 3, 5, 7))
                  + 1j * rng.standard_normal((2, 3, 5, 7))).astype(np.complex64),
        "weights": rng.standard_normal((13,)).astype(np.float32),
        "ids": rng.integers(-1000, 1000, size=(3, 11)).astype(np.int32),
        "mask": rng.integers(0, 255, size=(17,)).astype(np.uint8),
        "flag": np.asarray(7, np.uint8),
        "scale": np.asarray(1.5, np.float32),
        "cplx": (rng.standard_normal((1, 9)) + 1j).astype(np.complex64),
    }


@pytest.mark.parametrize("order", ["given", "reversed"])
def test_plan_layout_matches_reference(rng, order):
    arrays = _mixed(rng)
    items = list(arrays.items())
    if order == "reversed":
        items = items[::-1]
    specs = [(k, v.shape, v.dtype) for k, v in items]
    want = jarena.plan_layout(specs)
    got = tarena.plan_layout(specs)
    assert got.total_bytes == want.total_bytes
    assert [(e.name, e.shape, e.dtype, e.offset, e.nbytes) for e in got.entries] == \
        [(e.name, e.shape, e.dtype, e.offset, e.nbytes) for e in want.entries]
    assert all(e.offset % tarena.ALIGN == 0 for e in got.entries)
    assert tarena.ArenaLayout.from_json(want.to_json()) == got


def test_pack_host_byte_identical(rng):
    arrays = _mixed(rng)
    want_blob, want_layout = jarena.pack_host(arrays)
    got_blob, got_layout = tarena.pack_host(arrays)
    assert got_blob.dtype == np.uint8
    assert got_blob.tobytes() == np.asarray(want_blob).tobytes()  # exact bytes
    assert got_layout.to_json() == want_layout.to_json()


def test_unpack_host_round_trip(rng):
    arrays = _mixed(rng)
    blob, layout = tarena.pack_host(arrays)
    back = tarena.unpack_host(blob, layout)
    for k, v in arrays.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape
        np.testing.assert_array_equal(back[k], v)  # exact


def test_device_views_are_zero_copy_and_pack_device_round_trips(rng):
    arrays = _mixed(rng)
    blob, layout = tarena.pack_host(arrays)
    dev = torch.from_numpy(blob.copy())
    views = tarena.unpack_device(dev, layout)
    for k, v in arrays.items():
        np.testing.assert_array_equal(views[k].numpy(), v)  # exact
        e = layout.entry(k)
        assert views[k].data_ptr() == dev.data_ptr() + e.offset
    repacked = tarena.pack_device({k: torch.from_numpy(np.asarray(v)) for k, v in arrays.items()},
                                  layout)
    assert repacked.numpy().tobytes() == blob.tobytes()  # exact
    # writing a view writes the arena in place; packing the view is a no-op
    views["weights"].mul_(2)
    tarena.pack_device(views, layout, out=dev)
    np.testing.assert_array_equal(views["weights"].numpy(), arrays["weights"] * 2)


def test_data_from_reference_takes_a_jax_packed_kdata(rng):
    k = (rng.standard_normal((2, 3, 24, 20)) + 1j * rng.standard_normal((2, 3, 24, 20))
         ).astype(np.complex64)
    s = (rng.standard_normal((3, 24, 20)) + 1j * rng.standard_normal((3, 24, 20))
         ).astype(np.complex64)
    blob, layout = jarena.pack_host({"kdata": k, "sensitivity_maps": s})
    specs = [(e.name, e.shape, e.dtype) for e in layout.entries]
    data = interop.data_from_reference(np.asarray(blob), specs, "cpu")
    assert isinstance(data, KData)
    assert data.layout.to_json() == layout.to_json()
    assert data.device_blob.numpy().tobytes() == np.asarray(blob).tobytes()  # exact
    np.testing.assert_array_equal(data.kdata.host, k)
    np.testing.assert_array_equal(data.smaps.host, s)
    np.testing.assert_array_equal(data.device_view("kdata").numpy(), k)
    assert data.x_shape() == (2, 24, 20)
    # the Data's host arrays never alias its arena
    data.device_view("kdata").zero_()
    np.testing.assert_array_equal(data.kdata.host, k)


def test_arrays_from_reference_gives_xdata(rng):
    img = rng.standard_normal((2, 24, 20)).astype(np.float32)
    data = interop.arrays_from_reference({"xdata": img}, "cpu")
    assert isinstance(data, XData)
    np.testing.assert_array_equal(data.device_view("xdata").numpy(), img)  # exact
    with pytest.raises(ValueError):
        interop.data_from_reference(np.zeros(3, np.uint8), [("x", (4,), np.float32)], "cpu")


def test_add_data_refuses_an_arena_on_another_device(rng):
    """A Data made on one device cannot be fed to an app on another: the
    app's processes would otherwise run wherever the arena happens to lie.
    (``meta`` stands in for a second device on a CPU-only machine.)"""
    app = CLapp().init(PlatformTraits(), DeviceTraits(type=DeviceType.CPU))
    img = rng.standard_normal((2, 24, 20)).astype(np.float32)
    with pytest.raises(ValueError, match="lies on meta"):
        app.addData(interop.arrays_from_reference({"xdata": img}, "meta"))
    h = app.addData(interop.arrays_from_reference({"xdata": img}, app.device))
    np.testing.assert_array_equal(app.getData(h).device_view("xdata").numpy(), img)  # exact
