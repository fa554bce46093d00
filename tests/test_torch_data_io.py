"""The port's file formats (``repro_torch.data.io``) and the Data file
methods (``Data.save``/``load``/``matlab_save``, ``XData(path, dtype=)``,
``KData(path, variables=)``) against the JAX package's, on the CPU.

Files cross the packages in both directions: each reads what the other
wrote, to the same arrays and dtypes, and png, pgm, ppm and raw (with its
JSON sidecar) are the same bytes.  npz files hold the same arrays; their
zip headers carry a time stamp, so their bytes are not compared.
"""
import struct
import zlib

import ml_dtypes
import numpy as np
import pytest

from repro import core as jcore
from repro.data import io as jio
from repro_torch.core import (BFLOAT16, CLapp, Coherence, Data, DeviceTraits, DeviceType, KData,
                              NDArray, SyncSource, XData, process)
from repro_torch.data import io as tio
from repro_torch.launch import quickstart
from repro_torch.processes import Negate

BYTE_EXACT = (".png", ".pgm", ".ppm", ".raw")


def _cpu_app():
    return CLapp().init(device_traits=DeviceTraits(type=DeviceType.CPU))


def _cases(rng):
    """(extension, arrays written, arrays read back) for every format."""
    f32 = rng.standard_normal((4, 5, 6)).astype(np.float32)
    gray8 = rng.integers(0, 256, (7, 9)).astype(np.uint8)
    gray16 = rng.integers(0, 65536, (4, 5)).astype(np.uint16)
    rgb8 = rng.integers(0, 256, (5, 6, 3)).astype(np.uint8)
    rgba8 = rng.integers(0, 256, (3, 4, 4)).astype(np.uint8)
    flt = rng.random((6, 5)).astype(np.float32)
    flt8 = (np.clip(flt, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    many = {"k": (rng.standard_normal((2, 3)) + 1j * rng.standard_normal((2, 3))
                  ).astype(np.complex64),
            "n": rng.integers(0, 9, (5,)).astype(np.int32), "x": f32}
    return {
        "npz": (".npz", many, many),
        "npy": (".npy", {"v": f32}, {"data": f32}),
        "png8": (".png", {"i": gray8}, {"data": gray8}),
        "png16": (".png", {"i": gray16}, {"data": gray16}),
        "png_rgb": (".png", {"i": rgb8}, {"data": rgb8}),
        "png_rgba": (".png", {"i": rgba8}, {"data": rgba8}),
        "png_float": (".png", {"i": flt}, {"data": flt8}),
        "pgm": (".pgm", {"i": gray8}, {"data": gray8}),
        "pgm_float": (".pgm", {"i": flt}, {"data": flt8}),
        "ppm": (".ppm", {"i": rgb8}, {"data": rgb8}),
        "raw": (".raw", {"v": f32}, {"data": f32}),
        "raw_c64": (".raw", many, {"data": many["k"]}),
    }


CASES = list(_cases(np.random.default_rng(0)))


def _equal(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_port_round_trips(tmp_path, case):
    ext, arrays, want = _cases(np.random.default_rng(1))[case]
    path = str(tmp_path / ("x" + ext))
    tio.save_any(path, arrays)
    _equal(tio.load_any(path), want)


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("case", CASES)
def test_files_cross_the_packages(tmp_path, case, writer):
    """What one package writes, the other reads to the same arrays; png,
    pnm and raw files are the same bytes from either package."""
    ext, arrays, want = _cases(np.random.default_rng(2))[case]
    paths = {pkg: str(tmp_path / f"{pkg}{ext}") for pkg in ("jax", "torch")}
    jio.save_any(paths["jax"], arrays)
    tio.save_any(paths["torch"], arrays)
    reader = tio if writer == "jax" else jio
    _equal(reader.load_any(paths[writer]), want)
    if ext in BYTE_EXACT:
        suffixes = ("", ".json") if ext == ".raw" else ("",)
        for sfx in suffixes:
            with open(paths["jax"] + sfx, "rb") as a, open(paths["torch"] + sfx, "rb") as b:
                assert a.read() == b.read(), sfx


def test_npz_reads_the_requested_variables_only(tmp_path, rng):
    arrays = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.integers(0, 9, (5,)).astype(np.int32)}
    path = str(tmp_path / "x.npz")
    tio.save_any(path, arrays)
    assert list(tio.load_any(path, ["b"])) == ["b"]
    assert list(jio.load_any(path, ["b", "a"])) == list(tio.load_any(path, ["b", "a"]))


def _png_row_filtered(img: np.ndarray, bpp: int) -> bytes:
    """A gray8 PNG whose rows cycle through the five filters (the writers
    use filter 0 only), to hold the readers' unfiltering."""
    h, stride = img.shape[0], img.shape[1] * bpp
    rows = img.reshape(h, stride).astype(np.int32)
    raw = bytearray()
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, line = y % 5, rows[y]
        left = np.concatenate([np.zeros(bpp, np.int32), line[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if ftype == 0:
            pred = np.zeros(stride, np.int32)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        raw.append(ftype)
        raw.extend(((line - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = line

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))
    ihdr = struct.pack(">IIBBBBB", img.shape[1], h, 8, 0, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


def test_png_reader_undoes_every_filter(tmp_path, rng):
    img = rng.integers(0, 256, (10, 7)).astype(np.uint8)
    path = tmp_path / "filtered.png"
    path.write_bytes(_png_row_filtered(img, 1))
    for pkg in (tio, jio):
        np.testing.assert_array_equal(pkg.load_any(str(path))["data"], img)


def test_register_format_and_unknown_extensions(tmp_path, monkeypatch):
    monkeypatch.setattr(tio, "_READERS", dict(tio._READERS))
    monkeypatch.setattr(tio, "_WRITERS", dict(tio._WRITERS))

    def read_txt(path, variables=None):
        return {"data": np.loadtxt(path).astype(np.float32)}

    def write_txt(path, arrays):
        np.savetxt(path, np.asarray(next(iter(arrays.values()))))

    with pytest.raises(ValueError, match="no writer for '.txt'"):
        tio.save_any(str(tmp_path / "a.txt"), {"x": np.zeros(2)})
    with pytest.raises(ValueError, match="no reader for '.txt'"):
        tio.load_any(str(tmp_path / "a.txt"))
    tio.register_format(".txt", read_txt, write_txt)
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    XData({"x": x}).save(str(tmp_path / "a.txt"))
    back = XData.load(str(tmp_path / "a.txt"))
    np.testing.assert_array_equal(back.get_ndarray(0).host, x)
    assert back.names == ["data"] and isinstance(back, XData)


def test_xdata_from_a_file_with_a_dtype_and_from_another_data(tmp_path, rng):
    img = rng.integers(0, 256, (6, 8)).astype(np.uint8)
    path = str(tmp_path / "in.png")
    tio.save_any(path, {"img": img})
    want = jcore.XData(path, dtype=np.float32).get_ndarray(0).host
    d = XData(path, dtype=np.float32)
    got = d.get_ndarray(0).host
    assert got.dtype == np.float32 and d.coherence is Coherence.HOST_FRESH
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, img.astype(np.float32))
    assert XData(path).get_ndarray(0).host.dtype == np.uint8

    spec = XData(d, copy_values=False)       # an output the size of the input
    assert spec.specs() == d.specs() and spec.get_ndarray(0).host is None
    assert spec.coherence is Coherence.EMPTY
    copy = XData(d)
    np.testing.assert_array_equal(copy.get_ndarray(0).host, got)
    assert not np.shares_memory(copy.get_ndarray(0).host, got)
    assert XData(arrays={"a": img}).names == ["a"]


@pytest.mark.parametrize("reader", ["npz", "file_order"])
def test_kdata_pairs_variables_by_the_requested_names(tmp_path, rng, monkeypatch, reader):
    """The file stores the maps first; the k-space and maps are still
    paired by the names asked for, as in the JAX package, also through a
    reader that returns every variable in the file's order."""
    if reader == "file_order":
        monkeypatch.setitem(tio._READERS, ".npz", lambda path, variables=None: tio.load_npz(path))
    k = (rng.standard_normal((2, 3, 4, 5)) + 1j * rng.standard_normal((2, 3, 4, 5))
         ).astype(np.complex64)
    s = (rng.standard_normal((3, 4, 5)) + 1j * rng.standard_normal((3, 4, 5))
         ).astype(np.complex64)
    for order, names in (({"kdata": k, "sensitivity_maps": s}, None),
                         ({"maps": s, "ksp": k}, ["ksp", "maps"])):
        path = str(tmp_path / f"k{len(order)}{names is None}.npz")
        tio.save_any(path, order)
        got = KData(path, variables=names)
        want = jcore.KData(path, variables=names)
        assert got.names == want.names == ["kdata", "sensitivity_maps"]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.host, b.host)
        np.testing.assert_array_equal(got.kdata.host, k)
        np.testing.assert_array_equal(got.smaps.host, s)
        assert (got.n_frames, got.n_coils, got.x_shape()) == (2, 3, (2, 4, 5))
    with pytest.raises(KeyError, match="no_such"):
        KData(str(tmp_path / "k2False.npz"), variables=["ksp", "no_such"])
    with pytest.raises(ValueError, match="exactly"):
        KData(str(tmp_path / "k2False.npz"), variables=["ksp"])


def test_bfloat16_is_refused_not_written_as_uint16(tmp_path):
    """The port holds a bfloat16 array's host copy as uint16 bit patterns;
    saving one would write uint16, so ``Data.save`` refuses it, as the
    writers refuse an ``ml_dtypes`` bfloat16 array and the raw reader a
    bfloat16 volume the JAX package wrote."""
    d = Data([NDArray(np.ones((2, 3), np.float32), dtype=BFLOAT16, name="w")])
    assert d.get_ndarray(0).host.dtype == np.uint16
    for ext in (".npz", ".raw", ".npy"):
        with pytest.raises(ValueError, match="bfloat16"):
            d.save(str(tmp_path / f"w{ext}"))
        assert not (tmp_path / f"w{ext}").exists()
    bf = np.ones((2, 3), ml_dtypes.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        tio.save_any(str(tmp_path / "b.npz"), {"w": bf})
    jio.save_any(str(tmp_path / "j.raw"), {"w": bf})
    with pytest.raises(ValueError, match="bfloat16"):
        tio.load_any(str(tmp_path / "j.raw"))


def _graphs_through_a_stub(monkeypatch):
    """Compiled launches on the CPU: a capture runs nothing, a replay runs
    the launch's body."""
    def capture(body, device):
        return body
    monkeypatch.setattr(process, "capture_graph", capture)
    monkeypatch.setattr(process, "_graphs_on", lambda device: True)


@pytest.mark.parametrize("how", ["eager", "device_resident", "replayed"])
def test_save_auto_never_writes_a_stale_host_copy(tmp_path, rng, monkeypatch, how):
    """After a launch the device copy is the newer one and the host copy
    still holds the old values: ``save`` with AUTO syncs first, HOST_ONLY
    writes what the host holds."""
    if how == "replayed":
        _graphs_through_a_stub(monkeypatch)
    app = _cpu_app()
    x = rng.random((6, 5)).astype(np.float32)
    d_out = XData({"img": np.zeros_like(x)})
    h_in, h_out = app.addData(XData({"img": x})), app.addData(d_out)
    if how == "device_resident":
        d_out.residency = "device"
    p = Negate(app)
    p.in_handle, p.out_handle = h_in, h_out
    for _ in range(3 if how == "replayed" else 1):
        p.launch()
    assert p.replays == (2 if how == "replayed" else 0)
    assert d_out.coherence is (Coherence.DEVICE_RESIDENT if how == "device_resident"
                               else Coherence.DEVICE_FRESH)
    np.testing.assert_array_equal(d_out.get_ndarray(0).host, 0.0)   # stale
    d_out.save(str(tmp_path / "stale.npz"), SyncSource.HOST_ONLY)
    np.testing.assert_array_equal(np.load(tmp_path / "stale.npz")["img"], 0.0)
    d_out.matlab_save(str(tmp_path / "auto"))
    np.testing.assert_array_equal(np.load(tmp_path / "auto.npz")["img"], 1.0 - x)
    assert d_out.coherence is Coherence.IN_SYNC
    back = Data.load(str(tmp_path / "auto.npz"))
    np.testing.assert_array_equal(back.get_ndarray(0).host, 1.0 - x)


def test_save_refuses_what_has_no_values(tmp_path):
    with pytest.raises(ValueError, match="no storage"):
        XData([NDArray(shape=(2, 2), dtype=np.float32, name="a")]).save(
            str(tmp_path / "a.npz"))


def test_quickstart_reads_and_writes_png_files(tmp_path):
    """Listing 1 from an 8-bit PNG: read as f32 / 255, negated, written
    as 8 bits: the output file holds 255 - input."""
    img8 = (quickstart.synthetic_image(32) * 255.0 + 0.5).astype(np.uint8)
    in_png, out_png = str(tmp_path / "in.png"), str(tmp_path / "output.png")
    tio.save_any(in_png, {"img": img8})
    res = quickstart.run(_cpu_app(), runs=2, in_path=in_png, out_path=out_png)
    assert res["out_path"] == out_png and res["device"] == "cpu"
    np.testing.assert_array_equal(res["image"], 1.0 - img8.astype(np.float32) / 255.0)
    np.testing.assert_array_equal(tio.load_any(out_png)["data"], 255 - img8)
    np.testing.assert_array_equal(jio.load_any(out_png)["data"], 255 - img8)
