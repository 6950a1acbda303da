"""The port's video I/O library (flash_vstream_tpu_torch/native: its own
JPEG decoder, built here with the host C++ compiler) against the JAX
package's (flash_vstream_tpu/native/io.py over libjpeg-turbo) and PIL on
the same JPEGs.

Limits, as read on this file's JPEGs:
- at a JPEG's own size, and at any larger size (both libraries then decode
  at full size and run the same bilinear pass), bit-equal to JAX's library
  and to PIL's decoder, for 4:4:4, 4:2:2, 4:2:0 and 4:4:0 sampling,
  grayscale, optimized Huffman tables, restart markers and odd sizes; JAX's
  library parts only on images under 8 px a side, which it decodes at a
  reduced DCT scale even at their own size;
- at a smaller size JAX's library decodes at a reduced DCT scale and the
  port at full size before the same bilinear pass: on the smooth fixture
  scene within DOWNSCALE_MAX levels (mean under DOWNSCALE_MEAN), read
  max 3 and mean 0.3 at 224/336/448 -> 56-200 px; on noise the two part
  further (read up to 43 levels: the bilinear pass aliases what the DCT
  scale filters out), so the noisy case checks shape only;
- a Cb/Cr swap planted in a copy of the source is caught;
- a valid JPEG of a coding the decoder lacks (progressive, arithmetic,
  CMYK) decodes through PIL bit-equal to PIL's decode, and to JAX's library
  where that reads it; without PIL it raises IOError naming the reason;
- an image past MAX_PIXELS raises IOError on every route, and a failed
  allocation in the library raises IOError instead of ending the process.
"""
import io
import os
import shutil
import subprocess
import sys
import textwrap

import cv2
import numpy as np
import pytest
from PIL import Image

from flash_vstream_tpu.native import io as jio
from flash_vstream_tpu_torch.native import io as tio
from flash_vstream_tpu_torch.scripts.make_video_fixture import scene

DOWNSCALE_MAX = 4        # levels of 255, smooth scene, resized below size
DOWNSCALE_MEAN = 0.5


def _noisy(h, w, seed=0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 17.0) * np.cos(y / 23.0),
                    128 + 90 * np.cos(x / 11.0 - y / 29.0),
                    (x * 3 + y * 2) % 256], -1)
    return np.clip(img + rng.integers(-20, 20, img.shape), 0,
                   255).astype(np.uint8)


def _pil(img, **kw):
    b = io.BytesIO()
    Image.fromarray(img).save(b, "JPEG", **kw)
    return b.getvalue()


def _cv2(img, *params):
    ok, enc = cv2.imencode(".jpg", img[..., ::-1], list(params))
    assert ok
    return enc.tobytes()


def _cases():
    """(name, JPEG bytes) over sizes, samplings and encoders."""
    out = []
    for h, w in ((224, 224), (37, 53), (17, 9), (8, 8), (101, 203)):
        img = _noisy(h, w, seed=h)
        for sub in (0, 1, 2):
            for q in (50, 95):
                out.append((f"pil-{h}x{w}-sub{sub}-q{q}",
                            _pil(img, quality=q, subsampling=sub)))
        out.append((f"gray-{h}x{w}", _pil(img[..., 0], quality=85)))
        out.append((f"optimized-{h}x{w}", _pil(img, quality=85,
                                                optimize=True)))
        for rst in (1, 3):
            out.append((f"cv2-rst{rst}-{h}x{w}", _cv2(
                img, cv2.IMWRITE_JPEG_QUALITY, 80,
                cv2.IMWRITE_JPEG_RST_INTERVAL, rst)))
        for name, samp in (("440", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440),
                           ("422", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422)):
            out.append((f"cv2-{name}-{h}x{w}", _cv2(
                img, cv2.IMWRITE_JPEG_QUALITY, 80,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR, samp)))
    return out


CASES = _cases()


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    d = tmp_path_factory.mktemp("jpegs")
    paths = {}
    for name, blob in CASES:
        p = str(d / f"{name}.jpg")
        with open(p, "wb") as f:
            f.write(blob)
        paths[name] = p
    return paths


def _pil_decode(blob):
    return np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))


@pytest.mark.parametrize("name", [n for n, _ in CASES])
def test_full_size_bit_equal(jpegs, name):
    """decode_bytes (no target) and decode_file at the JPEG's own size equal
    PIL's decode and JAX's library bit for bit."""
    blob = dict(CASES)[name]
    want = _pil_decode(blob)
    h, w = want.shape[:2]
    got = tio.decode_bytes(blob)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tio.decode_file(jpegs[name], h, w), got)
    np.testing.assert_array_equal(jio.decode_file(jpegs[name], h, w), got)


@pytest.mark.parametrize("hw", [(448, 448), (300, 250), (224, 448)])
def test_upscale_bit_equal(jpegs, hw):
    """Above a JPEG's size both libraries decode at full size and resize
    with the same bilinear pass: bit-equal."""
    for name in ("pil-224x224-sub2-q95", "cv2-440-101x203",
                 "gray-224x224"):
        np.testing.assert_array_equal(tio.decode_file(jpegs[name], *hw),
                                      jio.decode_file(jpegs[name], *hw))


@pytest.mark.parametrize("target", [112, 160, 56])
def test_downscale_within_limit(tmp_path, target):
    """Below a JPEG's size (JAX: DCT-domain scaling; the port: full decode)
    on the smooth scene at 224 and 448 px: within DOWNSCALE_MAX levels and
    DOWNSCALE_MEAN on average; the noisy JPEG only in shape."""
    for side in (224, 448):
        for i, img in enumerate(scene(2, side, seed=3)):
            p = str(tmp_path / f"{side}_{i}.jpg")
            Image.fromarray(img).save(p, quality=90)
            got = tio.decode_file(p, target, target).astype(int)
            want = jio.decode_file(p, target, target).astype(int)
            err = np.abs(got - want)
            assert err.max() <= DOWNSCALE_MAX and err.mean() < DOWNSCALE_MEAN
            np.testing.assert_array_equal(
                tio.decode_bytes(open(p, "rb").read(), target, target),
                got)
    p = str(tmp_path / "noisy.jpg")
    Image.fromarray(_noisy(224, 224)).save(p, quality=90)
    assert tio.decode_file(p, target, target).shape == (target, target, 3)


def test_decode_batch_zeroes_a_bad_slot(jpegs, tmp_path):
    """decode_batch against JAX's: the same frames, and a file that fails
    (not a JPEG; missing) leaves its slot zeroed in both."""
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"not a jpeg at all")
    paths = [jpegs["pil-224x224-sub2-q95"], str(bad),
             jpegs["cv2-rst3-224x224"], str(tmp_path / "missing.jpg"),
             jpegs["gray-224x224"]]
    got = tio.decode_batch(paths, 224, 224)
    want = jio.decode_batch(paths, 224, 224)
    np.testing.assert_array_equal(got, want)
    assert not got[1].any() and not got[3].any() and got[0].any()
    assert tio.decode_batch([], 8, 8).shape == (0, 8, 8, 3)


def test_prefetch_loader_order(jpegs, tmp_path):
    """PrefetchLoader yields the frames in path order, equal to JAX's loader
    (a bad file zeroed), at depths below and above the frame count; an
    early close stops the worker."""
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"\xff\xd8 truncated")
    names = [n for n, _ in CASES if n.endswith("224x224")]
    paths = [jpegs[n] for n in names] + [str(bad)]
    want = list(jio.PrefetchLoader(paths, 224, 224, prefetch_depth=2))
    for depth in (1, 3, 64):
        got = list(tio.PrefetchLoader(paths, 224, 224,
                                      prefetch_depth=depth))
        assert len(got) == len(paths)
        for i, (a, b) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(a, b, err_msg=str(i))
        assert not got[-1].any()
    loader = tio.PrefetchLoader(paths, 64, 64, prefetch_depth=2)
    next(loader)
    loader.close()
    with pytest.raises(StopIteration):
        next(loader)


def _with_marker(blob, old, new):
    i = blob.index(old)
    return blob[:i] + new + blob[i + len(old):]


def _refused_cases():
    """(reason the library gives, JPEG bytes) of codings it lacks."""
    img = _noisy(32, 32)
    base = _pil(img, quality=90)
    cmyk = io.BytesIO()
    Image.new("CMYK", (16, 16), (1, 2, 3, 4)).save(cmyk, "JPEG")
    return {
        "progressive": _pil(img, quality=90, progressive=True),
        "arithmetic": _with_marker(base, b"\xff\xc0", b"\xff\xc9"),
        "12-bit": _with_marker(base, b"\xff\xc0\x00\x11\x08",
                               b"\xff\xc0\x00\x11\x0c"),
        "4 components": cmyk.getvalue(),
    }


def _hide_pil(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)


def test_refusals_name_the_file_and_reason(tmp_path, monkeypatch):
    """Without PIL, progressive, arithmetic-coded, 12-bit and CMYK files
    raise IOError naming the file and the reason; in a batch and in the
    loader their slots come out zeroed."""
    cases = _refused_cases()
    _hide_pil(monkeypatch)
    paths = []
    for why, blob in cases.items():
        p = tmp_path / f"{why.replace(' ', '_')}.jpg"
        p.write_bytes(blob)
        paths.append(str(p))
        with pytest.raises(IOError, match=f"{p}: .*{why}.*PIL"):
            tio.decode_file(str(p), 16, 16)
        with pytest.raises(IOError, match=f"clip 3: .*{why}"):
            tio.decode_bytes(blob, name="clip 3")
    assert not tio.decode_batch(paths, 16, 16).any()
    assert not np.any(list(tio.PrefetchLoader(paths, 16, 16)))
    with pytest.raises(IOError, match="no SOI"):
        tio.decode_bytes(b"\x89PNG\r\n\x1a\n")


@pytest.mark.parametrize("why", ["progressive", "arithmetic",
                                 "4 components"])
def test_refused_codings_decode_through_pil(tmp_path, why):
    """A coding the library refuses decodes through PIL on every entry: at
    full size PIL's own frame, at a larger size the library's bilinear pass
    over it (JAX's library's frame where it reads the file)."""
    blob = _refused_cases()[why]
    p = tmp_path / "refused.jpg"
    p.write_bytes(blob)
    want = _pil_decode(blob)
    h, w = want.shape[:2]
    np.testing.assert_array_equal(tio.decode_bytes(blob), want)
    np.testing.assert_array_equal(tio.decode_file(str(p), h, w), want)
    big = tio.decode_file(str(p), 2 * h + 3, 2 * w)
    np.testing.assert_array_equal(tio.decode_bytes(blob, 2 * h + 3, 2 * w),
                                  big)
    if why != "4 components":              # libjpeg gives no RGB of CMYK
        np.testing.assert_array_equal(
            jio.decode_file(str(p), 2 * h + 3, 2 * w), big)
    good = dict(CASES)["gray-17x9"]
    q = tmp_path / "good.jpg"
    q.write_bytes(good)
    batch = tio.decode_batch([str(q), str(p)], h, w)
    np.testing.assert_array_equal(batch[1], want)
    np.testing.assert_array_equal(batch[0], tio.decode_bytes(good, h, w))
    loaded = list(tio.PrefetchLoader([str(p), str(q), str(p)], h, w,
                                     prefetch_depth=1))
    np.testing.assert_array_equal(np.stack(loaded),
                                  np.stack([want, batch[0], want]))


def test_unreadable_refused_coding_names_both_reasons(tmp_path):
    """A refused coding PIL cannot read either raises IOError with the
    library's reason and PIL's."""
    blob = _refused_cases()["12-bit"]
    with pytest.raises(IOError, match="x: 12-bit samples.*; PIL: "):
        tio.decode_bytes(blob, name="x")


def _huge_sof(marker=0xC0, h=65535, w=65535):
    """A JPEG of a few bytes whose SOF declares h x w pixels."""
    return (b"\xff\xd8\xff" + bytes([marker]) + b"\x00\x11\x08"
            + h.to_bytes(2, "big") + w.to_bytes(2, "big")
            + b"\x03\x01\x11\x00\x02\x11\x01\x03\x11\x01\xff\xd9")


@pytest.mark.parametrize("marker", [0xC0, 0xC2, 0xC9])
def test_pixel_cap_refuses_before_allocating(tmp_path, marker):
    """A SOF past MAX_PIXELS (65535 x 65535, or one pixel over the cap)
    raises IOError on every route, the HTTP server's image bodies
    included, whatever the coding (no route hands it to PIL)."""
    from flash_vstream_tpu_torch.serve.http_server import _decode_body
    over = tio.MAX_PIXELS // 13107 + 1                 # x 13107 > cap
    for blob in (_huge_sof(marker), _huge_sof(marker, over, 13107)):
        p = tmp_path / "huge.jpg"
        p.write_bytes(blob)
        for call in (lambda: tio.decode_bytes(blob),
                     lambda: tio.decode_bytes(blob, 8, 8),
                     lambda: tio.decode_file(str(p), 8, 8),
                     lambda: tio.jpeg_hw(blob),
                     lambda: _decode_body(blob, "image/jpeg")):
            with pytest.raises(IOError, match="pixels a JPEG may have"):
                call()
        assert not tio.decode_batch([str(p)], 8, 8).any()
        assert not np.any(list(tio.PrefetchLoader([str(p)], 8, 8)))
    assert tio.jpeg_hw(_huge_sof(marker, 13107, 13653)) == (13107, 13653)


def test_failed_allocation_raises_instead_of_aborting(tmp_path):
    """In a process whose address space is capped, a JPEG under MAX_PIXELS
    whose planes do not fit makes the library's allocation throw: each C
    entry turns that into an error (IOError; a zeroed slot in the batch and
    the loader) and the process lives on."""
    p = tmp_path / "big.jpg"
    p.write_bytes(_huge_sof(0xC0, 12000, 12000))     # 0.9 GB of planes
    script = textwrap.dedent(f"""
        import resource
        import numpy as np
        from flash_vstream_tpu_torch.native import io as tio
        tio.library()
        with open("/proc/self/status") as f:
            vm = [l for l in f if l.startswith("VmSize")][0]
        cap = int(vm.split()[1]) * 1024 + 256 * 2**20
        resource.setrlimit(resource.RLIMIT_AS, (cap, cap))
        blob = open({str(p)!r}, "rb").read()
        try:
            tio.decode_bytes(blob, 8, 8)
        except IOError as e:
            print("raised:", e)
        print("batch zero:", not tio.decode_batch([{str(p)!r}], 8, 8).any())
        print("loader zero:",
              not np.any(list(tio.PrefetchLoader([{str(p)!r}], 8, 8))))
    """)
    tio.library()                        # built here, not under the cap
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, cwd=tio.BUILD_DIR.parents[1],
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "raised: JPEG bytes: the decoder threw" in proc.stdout
    assert "batch zero: True" in proc.stdout
    assert "loader zero: True" in proc.stdout


def test_library_path_names_the_compiler(tmp_path, monkeypatch):
    """The library's name hashes the compiler's version and the machine:
    a build directory carried to a host with another compiler is rebuilt
    there, not loaded."""
    ours = tio.library_path()
    fake = tmp_path / "fake-g++"
    fake.write_text("#!/bin/sh\necho 'fake g++ 99.0'\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    other = tio.library_path()
    assert other != ours and other.parent == ours.parent
    assert "fake g++ 99.0" in tio._toolchain(str(fake))


def test_built_from_the_port_source_into_build():
    """The library is built from csrc/vstream_io.cpp into the repository's
    build/flash_vstream_tpu_torch/, named by the source's hash."""
    path = tio.library_path()
    assert path.parent == tio.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "flash_vstream_tpu_torch")
    assert tio.native_available() and path.exists()
    assert tio.SOURCE.parent.name == "csrc"
    assert "jpeglib" not in tio.SOURCE.read_text()


def test_build_failure_raises(tmp_path):
    """A source that does not compile raises with the compiler's output."""
    src = tmp_path / "broken.cpp"
    src.write_text("int main( { return 0; }\n")
    with pytest.raises(RuntimeError, match="(?s)failed:.*broken.cpp.*error"):
        tio.build(src, tmp_path / "build")
    assert not list((tmp_path / "build").glob("*.so"))


def test_planted_chroma_swap_is_caught(tmp_path):
    """A copy of the source with Cb and Cr swapped in the colour
    conversion builds and decodes, and the comparison of
    test_full_size_bit_equal catches it on a colour JPEG."""
    src = tmp_path / "vstream_io.cpp"
    text = tio.SOURCE.read_text()
    old = ("    const uint8_t* cb = full[1].data();\n"
           "    const uint8_t* cr = full[2].data();\n")
    assert old in text
    src.write_text(text.replace(old, old.replace("full[1]", "full[9]")
                                .replace("full[2]", "full[1]")
                                .replace("full[9]", "full[2]")))
    lib = tio.load(src, tmp_path / "build")
    blob = dict(CASES)["pil-224x224-sub2-q95"]
    want = _pil_decode(blob)
    out = np.empty_like(want)
    assert lib.vio_decode_mem(blob, len(blob), 224, 224,
                              out.ctypes.data_as(tio._U8P)) == 0
    assert np.abs(out.astype(int) - want).max() > DOWNSCALE_MAX
    shutil.rmtree(tmp_path / "build")
