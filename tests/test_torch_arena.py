"""The port's arena against the JAX package's: same offsets, same bytes.

Arena bytes are compared exactly (the format is shared); round trips and
``interop`` take-overs are compared exactly too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import arena as jarena
from repro_torch import interop
import repro_torch.core as tcore
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


def test_bfloat16_entries_cross_packages_byte_for_byte(rng):
    """A JAX-packed blob with bfloat16 and int32 entries unpacks in the port
    with the same bytes (bfloat16 as uint16 bit patterns on the host,
    torch.bfloat16 on the device), and a port-packed one unpacks in JAX."""
    x32 = rng.standard_normal((3, 5)).astype(np.float32)
    s32 = np.asarray(rng.standard_normal(), np.float32)
    jw = np.asarray(jnp.asarray(x32, jnp.bfloat16))
    js = np.asarray(jnp.asarray(s32, jnp.bfloat16))
    ids = rng.integers(-1000, 1000, size=(7,)).astype(np.int32)
    blob, layout = jarena.pack_host({"w": jw, "ids": ids, "s": js})
    blob = np.asarray(blob)
    assert [e.dtype for e in layout.entries] == ["bfloat16", "int32", "bfloat16"]
    got = tarena.plan_layout([(e.name, e.shape, e.dtype) for e in layout.entries])
    assert got.to_json() == layout.to_json()
    host = tarena.unpack_host(blob, got)
    assert host["w"].dtype == np.uint16 and host["w"].tobytes() == jw.tobytes()  # exact
    np.testing.assert_array_equal(host["ids"], ids)
    dev = tarena.unpack_device(torch.from_numpy(blob.copy()), got)
    assert dev["w"].dtype == torch.bfloat16
    # the same rounding of the same f32 values in both frameworks
    assert torch.equal(dev["w"], torch.from_numpy(x32).to(torch.bfloat16))
    # port-packed from torch bfloat16 tensors: JAX reads the same values
    tblob, tlayout = tarena.pack_host({"w": torch.from_numpy(x32).to(torch.bfloat16),
                                       "ids": ids,
                                       "s": torch.from_numpy(s32).to(torch.bfloat16)})
    assert tlayout.to_json() == layout.to_json()
    assert tblob.tobytes() == blob.tobytes()  # exact
    back = jarena.unpack_host(tblob, layout)
    np.testing.assert_array_equal(np.asarray(back["w"], np.float32), np.asarray(jw, np.float32))
    np.testing.assert_array_equal(np.asarray(back["s"], np.float32), np.asarray(js, np.float32))


def test_bfloat16_data_round_trips_through_the_device(rng):
    """A Data with a bfloat16 array: host bits, device view in bfloat16, and
    back to the host unchanged; f32 values given for a bfloat16 array are
    rounded as torch rounds them."""
    x32 = rng.standard_normal((4, 6)).astype(np.float32)
    app = CLapp().init(PlatformTraits(), DeviceTraits(type=DeviceType.CPU))
    data = tcore.Data({"w": tcore.NDArray(x32, dtype="bfloat16"), "n": np.arange(3)})
    assert data.specs()["w"] == tcore.TensorSpec((4, 6), "bfloat16")
    h = app.addData(data)
    view = data.device_view("w")
    assert view.dtype == torch.bfloat16
    assert torch.equal(view, torch.from_numpy(x32).to(torch.bfloat16))
    view.mul_(2)
    app.device2Host(h)
    assert torch.equal(torch.from_numpy(data.get_ndarray(0).host.view(np.int16)).view(
        torch.bfloat16), torch.from_numpy(2 * x32).to(torch.bfloat16))
