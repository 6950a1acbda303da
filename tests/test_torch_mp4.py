"""The port's MJPEG-mp4 demuxer/muxer (preprocess/mp4.py), `load_video`'s
container chain, the frame-directory loader and probes
(preprocess/video.py) and `scripts/extract_frames.py` against the JAX
package's on the same files, on the CPU. The port decodes JPEG with its own
library (built here with the host C++ compiler); JAX with PIL or libjpeg.
Frames are held bit for bit wherever both decode at full size (the port's
decoder equals PIL's there: tests/test_torch_native_io.py); below a frame's
size within that file's DOWNSCALE_MAX."""
import io
import os
import shutil
import stat
import sys

import cv2
import numpy as np
import pytest
from PIL import Image

from flash_vstream_tpu.preprocess import mp4 as jmp4
from flash_vstream_tpu.preprocess import video as jvideo
from flash_vstream_tpu_torch.native import io as tvio
from flash_vstream_tpu_torch.preprocess import mp4 as tmp4
from flash_vstream_tpu_torch.preprocess import video as tvideo
from flash_vstream_tpu_torch.scripts import extract_frames as textract
from flash_vstream_tpu_torch.scripts.make_video_fixture import scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "video")
DOWNSCALE_MAX = 4        # as tests/test_torch_native_io.py


def _frames(n=8, side=64, seed=0):
    return scene(n, side, seed=seed)


def _equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f"frame {i}")


@pytest.fixture
def no_cv2(monkeypatch):
    """Both packages' chains as on a machine without OpenCV."""
    monkeypatch.setattr(jvideo, "_decode_cv2", lambda *a, **k: None)
    monkeypatch.setattr(tvideo, "_decode_cv2", lambda *a, **k: None)


@pytest.fixture
def mjpeg(tmp_path):
    """An MJPEG mp4 that JAX's muxer wrote: 12 frames at 6 fps."""
    path = str(tmp_path / "clip.mp4")
    jmp4.mux_mjpeg(path, _frames(12), fps=6.0)
    return path


def test_parse_mp4_matches_jax(mjpeg):
    """Sizes, offsets, codec, timescale, duration and fps of JAX's file."""
    j, t = jmp4.parse_mp4(mjpeg), tmp4.parse_mp4(mjpeg)
    assert t.sample_sizes == j.sample_sizes
    assert t.sample_offsets == j.sample_offsets
    assert (t.codec, t.timescale, t.duration, t.n_samples, t.fps) == (
        j.codec, j.timescale, j.duration, j.n_samples, j.fps) == (
        b"jpeg", 6000, 12000, 12, 6.0)
    with pytest.raises(ValueError, match="no moov"):
        tmp4.parse_mp4(mjpeg, data=b"\x00\x00\x00\x08free")


def test_mux_matches_jax(tmp_path, monkeypatch):
    """The port's muxer writes JAX's bytes from arrays, and from the JPEG
    bytes as they are with PIL unimportable."""
    frames = _frames(5)
    jpath, tpath = str(tmp_path / "j.mp4"), str(tmp_path / "t.mp4")
    jmp4.mux_mjpeg(jpath, frames, fps=3.0, quality=80)
    tmp4.mux_mjpeg(tpath, frames, fps=3.0, quality=80)
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    blobs, _ = jmp4.demux_mjpeg(jpath)
    monkeypatch.setitem(sys.modules, "PIL", None)
    bpath = str(tmp_path / "b.mp4")
    tmp4.mux_mjpeg(bpath, blobs, fps=3.0)
    assert open(bpath, "rb").read() == open(jpath, "rb").read()


def test_demux_blobs_equal(mjpeg):
    jb, jfps = jmp4.demux_mjpeg(mjpeg)
    tb, tfps = tmp4.demux_mjpeg(mjpeg)
    assert tb == jb and tfps == jfps and len(tb) == 12


@pytest.mark.parametrize("fps,max_frames", [(None, None), (3.0, None),
                                            (2.0, None), (None, 5),
                                            (3.0, 4), (12.0, 20)])
def test_decode_mjpeg_equal(mjpeg, fps, max_frames):
    """decode_mjpeg's frames (own decoder) equal JAX's (PIL), with the fps
    subsampling and the max_frames spread."""
    got = tmp4.decode_mjpeg(mjpeg, fps=fps, max_frames=max_frames)
    _equal(got, jmp4.decode_mjpeg(mjpeg, fps=fps, max_frames=max_frames))


@pytest.mark.parametrize("fps,max_frames", [(1.0, None), (6.0, None),
                                            (3.0, 5), (6.0, 3)])
def test_load_video_demuxer_branch(mjpeg, no_cv2, fps, max_frames):
    """Without cv2, load_video takes the MJPEG demuxer in both packages."""
    _equal(tvideo.load_video(mjpeg, fps=fps, max_frames=max_frames),
           jvideo.load_video(mjpeg, fps=fps, max_frames=max_frames))


@pytest.mark.parametrize("fps,max_frames", [(1.0, None), (6.0, 5)])
def test_load_video_cv2_branch_on_mjpeg(mjpeg, fps, max_frames):
    """With cv2, both packages decode the MJPEG file through cv2 first."""
    got = tvideo.load_video(mjpeg, fps=fps, max_frames=max_frames)
    _equal(got, jvideo.load_video(mjpeg, fps=fps, max_frames=max_frames))


def _write_cv2_mp4(path, n=10, fps=10.0, hw=(48, 64)):
    h, w = hw
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (w, h))
    if not writer.isOpened():
        pytest.skip("this cv2 build has no mp4 encoder")
    for i, f in enumerate(scene(n, max(hw), seed=5)):
        writer.write(np.ascontiguousarray(f[:h, :w, ::-1]))
    writer.release()
    return path


@pytest.mark.parametrize("fps,max_frames", [(10.0, None), (5.0, None),
                                            (10.0, 3), (2.0, 2)])
def test_load_video_cv2_in_process(tmp_path, fps, max_frames):
    """An mp4v file cv2.VideoWriter wrote (not MJPEG): cv2's in-process
    decode in both packages, equal frames."""
    path = _write_cv2_mp4(str(tmp_path / "clip.mp4"))
    got = tvideo.load_video(path, fps=fps, max_frames=max_frames)
    _equal(got, jvideo.load_video(path, fps=fps, max_frames=max_frames))
    assert len(got) == (max_frames or int(10 / round(10.0 / fps)))


def test_sibling_directory(tmp_path):
    """A sibling frame directory wins over the file, in both packages."""
    d = tmp_path / "clip"
    d.mkdir()
    for t, f in enumerate(_frames(6, 40)):
        Image.fromarray(f).save(str(d / f"{t:06d}.jpg"))
    path = str(tmp_path / "clip.mp4")
    (tmp_path / "clip.mp4").write_bytes(b"\x00" * 16)   # not an mp4 at all
    _equal(tvideo.load_video(path, max_frames=4),
           jvideo.load_video(path, max_frames=4))
    assert tvideo.probe_video_len(path) == jvideo.probe_video_len(path) == 6
    assert tvideo.probe_video_hw(path) == jvideo.probe_video_hw(path) == (
        40, 40)


def _h264_like_mp4(tmp_path):
    """An mp4 whose samples are not JPEG (stands in for H.264 content)."""
    path = str(tmp_path / "clip.mp4")
    jmp4.mux_mjpeg(path, _frames(2), fps=1.0)
    data = bytearray(open(path, "rb").read())
    for off in jmp4.parse_mp4(path).sample_offsets:
        data[off:off + 2] = b"\x00\x00"
    open(path, "wb").write(bytes(data))
    return path


def test_h264_sample_raises(tmp_path, no_cv2, monkeypatch):
    """Non-JPEG samples: demux_mjpeg raises ValueError with instructions,
    and with no ffmpeg load_video raises JAX's RuntimeError."""
    path = _h264_like_mp4(tmp_path)
    with pytest.raises(ValueError, match="Pre-extract frames"):
        tmp4.demux_mjpeg(path)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    for mod in (tvideo, jvideo):
        with pytest.raises(RuntimeError, match="no ffmpeg on PATH"):
            mod.load_video(path)
    with pytest.raises(RuntimeError, match="needs OpenCV"):
        tvideo.load_video(str(tmp_path / "clip.avi"))
    with pytest.raises(RuntimeError, match="No decoder registered"):
        tvideo.load_video(str(tmp_path / "clip.xyz"))


def test_ffmpeg_branch(tmp_path, no_cv2, monkeypatch):
    """With an ffmpeg binary on PATH (a fake that writes 4 JPEGs at the
    output pattern), both packages extract to the sibling directory at 1
    fps and serve it; the second load reads the cache."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    fake = bindir / "ffmpeg"
    fake.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "import numpy as np\n"
        "from PIL import Image\n"
        "pattern = sys.argv[-1]\n"
        "assert sys.argv[sys.argv.index('-vf') + 1] == 'fps=1.0'\n"
        "for i in range(1, 5):\n"
        "    Image.fromarray(np.full((32, 48, 3), i * 30, np.uint8)).save("
        "pattern % i)\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH",
                       f"{bindir}{os.pathsep}" + os.environ.get("PATH", ""))
    frames = {}
    for name, mod in (("torch", tvideo), ("jax", jvideo)):
        sub = tmp_path / name
        sub.mkdir()
        path = _h264_like_mp4(sub)
        frames[name] = list(mod.load_video(path, fps=2.0, max_frames=3))
        assert os.path.isdir(str(sub / "clip"))
        assert len(mod.load_video(path)) == 4
        assert mod.probe_video_len(path) == 4
    _equal(frames["torch"], frames["jax"])


def _dirs(tmp_path):
    """Frame directories: JPEG, PNG, and (the port only) .npy."""
    frames = _frames(7, 56, seed=2)
    out = {}
    for ext in ("jpg", "png", "npy"):
        d = tmp_path / ext
        d.mkdir()
        for t, f in enumerate(frames):
            p = str(d / f"{t:06d}.{ext}")
            if ext == "npy":
                np.save(p, f[:, :40])
            else:
                Image.fromarray(f[:, :40]).save(p)
        out[ext] = str(d)
    return out


def test_probes_of_every_source(tmp_path, monkeypatch):
    """probe_video_hw and probe_video_len against JAX's for frame
    directories, the MJPEG mp4 (cv2 and sample-table branches), a cv2 mp4,
    a sibling directory and a registered decoder; PIL never imported for a
    JPEG or PNG header."""
    dirs = _dirs(tmp_path)
    mp = str(tmp_path / "m.mp4")
    jmp4.mux_mjpeg(mp, _frames(9, 48), fps=3.0)
    cv = _write_cv2_mp4(str(tmp_path / "cv.mp4"), n=7)
    sib = tmp_path / "sib"
    shutil.copytree(dirs["jpg"], str(sib))
    (tmp_path / "sib.mp4").write_bytes(b"")
    for reg in (tvideo, jvideo):
        reg.register_video_decoder("fake8", lambda p, fps: list(
            tvideo.SyntheticSource(9, 8, 12)))
    sources = [dirs["jpg"], dirs["png"], mp, cv, str(tmp_path / "sib.mp4"),
               str(tmp_path / "x.fake8")]
    for path in sources:
        assert tvideo.probe_video_hw(path) == jvideo.probe_video_hw(path), \
            path
        assert tvideo.probe_video_len(path) == jvideo.probe_video_len(
            path), path
    assert tvideo.probe_video_hw(dirs["npy"]) == (56, 40)
    assert tvideo.probe_video_len(dirs["npy"]) == 7
    # the sample table when cv2 cannot say
    monkeypatch.setattr(tvideo, "_decode_cv2", lambda *a, **k: None)
    assert tvideo.probe_video_len(mp) == 9
    # headers in Python: no PIL for JPEG, PNG and .npy
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    for ext in ("jpg", "png", "npy"):
        assert tvideo.probe_video_hw(dirs[ext]) == (56, 40)


def test_frame_dirs_and_resize(tmp_path, monkeypatch):
    """load_frame_dir against JAX's: JPEG and PNG directories at full size
    (bit-equal), with resize_hw above the frames' size (bit-equal) and
    below it (within DOWNSCALE_MAX); `.npy` frames equal the arrays;
    resize_hw refuses `.npy` frames; JPEG reads never import PIL."""
    dirs = _dirs(tmp_path)
    for ext in ("jpg", "png"):
        _equal(tvideo.load_frame_dir(dirs[ext], max_frames=5),
               jvideo.load_frame_dir(dirs[ext], max_frames=5))
    _equal(tvideo.load_frame_dir(dirs["jpg"], resize_hw=(112, 80)),
           jvideo.load_frame_dir(dirs["jpg"], resize_hw=(112, 80)))
    for a, b in zip(tvideo.load_frame_dir(dirs["jpg"], resize_hw=(28, 20)),
                    jvideo.load_frame_dir(dirs["jpg"], resize_hw=(28, 20))):
        assert np.abs(a.astype(int) - b).max() <= DOWNSCALE_MAX
    _equal(tvideo.load_frame_dir(dirs["npy"], fps=1.0, source_fps=2.0),
           [np.load(os.path.join(dirs["npy"], f"{t:06d}.npy"))
            for t in (0, 2, 4, 6)])
    with pytest.raises(ValueError, match="JPEG frames only"):
        tvideo.load_frame_dir(dirs["npy"], resize_hw=(8, 8))
    want = list(jvideo.load_frame_dir(dirs["jpg"]))
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    _equal(tvideo.load_frame_dir(dirs["jpg"]), want)
    _equal([tvideo.read_frame(os.path.join(dirs["jpg"], f"{t:06d}.jpg"))
            for t in range(7)], want)


def test_image_hw_reads_headers(tmp_path):
    """image_hw from a JPEG's SOF (past large APP segments), a PNG's IHDR
    and a `.npy` header, against PIL's sizes."""
    img = _frames(1, 70)[0][:50]
    p = str(tmp_path / "exif.jpg")
    b = io.BytesIO()
    Image.fromarray(img).save(b, "JPEG")
    app = b"\xff\xef" + (60002).to_bytes(2, "big") + b"\x00" * 60000
    with open(p, "wb") as f:        # two APP15 segments: the SOF lies past
        f.write(b.getvalue()[:2] + app + app + b.getvalue()[2:])   # 64 KiB
    assert tvideo.image_hw(p) == (50, 70)
    q = str(tmp_path / "a.png")
    Image.fromarray(img).save(q)
    assert tvideo.image_hw(q) == (50, 70)
    g = str(tmp_path / "a.gif")
    Image.fromarray(img).save(g)
    assert tvideo.image_hw(g) == (50, 70)
    with pytest.raises(IOError, match="not a JPEG"):
        tvio.jpeg_hw(b"GIF89a")


@pytest.mark.parametrize("fmt", ["jpg", "npy"])
def test_extract_frames(tmp_path, fmt, monkeypatch):
    """The port's extract_frames on a directory and on an mp4 (no ffmpeg
    here: the load_video chain) against JAX's script: JPEG files equal
    byte for byte; `.npy` frames equal the frames JAX's files decode to
    before encoding (its load_video frames)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "jax_extract_frames", os.path.join(ROOT, "scripts",
                                           "extract_frames.py"))
    jextract = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jextract)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    videos = tmp_path / "videos"
    videos.mkdir()
    jmp4.mux_mjpeg(str(videos / "a.mp4"), _frames(6, 48), fps=2.0)
    d = videos / "b"
    d.mkdir()
    for t, f in enumerate(_frames(3, 32)):
        Image.fromarray(f).save(str(d / f"f{t}.jpg"))
    out = tmp_path / "out"
    assert textract.main(["--video_dir", str(videos), "--frame_dir",
                          str(out), "--fps", "1", "--format", fmt]) == 2
    jout = tmp_path / "jout"
    for v in ("a.mp4", "b"):
        assert jextract.extract_one(str(videos / v), str(
            jout / os.path.splitext(v)[0]), 1.0)
    for v in ("a", "b"):
        names = sorted(os.listdir(out / v))
        jnames = sorted(os.listdir(jout / v))
        assert len(names) == len(jnames) == 3
        for n, jn in zip(names, jnames):
            if fmt == "jpg" or v == "b":
                assert n == jn
                assert (out / v / n).read_bytes() == (jout / v / jn
                                                      ).read_bytes()
            else:
                assert n.endswith(".npy")
        if fmt == "npy" and v == "a":
            _equal(tvideo.load_frame_dir(str(out / v)),
                   jvideo.load_video(str(videos / "a.mp4"), fps=1.0))


def test_fixture(no_cv2):
    """The committed fixture (flash_vstream_tpu_torch/scripts/
    make_video_fixture.py): JAX's decode_mjpeg gives its expected frames;
    the port's demuxer, its load_video (the demuxer branch) and its
    frame-directory load give them bit for bit; under 1 MB in all."""
    mp4 = os.path.join(FIXTURE, "scene.mp4")
    want = np.load(os.path.join(FIXTURE, "scene_expected.npz"))["frames"]
    assert want.shape == (16, 224, 224, 3)
    _equal(jmp4.decode_mjpeg(mp4, fps=8.0), want)
    _equal(tmp4.decode_mjpeg(mp4, fps=8.0), want)
    _equal(tvideo.load_video(mp4, fps=8.0), want)
    _equal(tvideo.load_frame_dir(os.path.join(FIXTURE, "scene_frames"),
                                 fps=8.0, source_fps=8.0), want)
    assert tmp4.parse_mp4(mp4).fps == 8.0
    total = sum(os.path.getsize(os.path.join(dp, f))
                for dp, _, fs in os.walk(FIXTURE) for f in fs)
    assert total < 1 << 20
    # the JPEG bytes of the directory are the mp4's samples
    blobs, _ = tmp4.demux_mjpeg(mp4)
    for i, b in enumerate(blobs):
        with open(os.path.join(FIXTURE, "scene_frames", f"{i:06d}.jpg"),
                  "rb") as f:
            assert f.read() == b
    # and they encode the seeded scene (JPEG-lossy)
    err = np.abs(want.astype(int) - np.stack(scene()))
    assert err.mean() < 2


def test_http_image_body_uses_the_port_decoder(monkeypatch):
    """The HTTP server's JPEG body decodes without PIL, equal to PIL's."""
    from flash_vstream_tpu_torch.serve.http_server import _decode_body
    f = _frames(1, 40)[0]
    b = io.BytesIO()
    Image.fromarray(f).save(b, "JPEG", quality=90)
    want = np.asarray(Image.open(io.BytesIO(b.getvalue())).convert("RGB"))
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    (got,) = _decode_body(b.getvalue(), "image/jpeg")
    np.testing.assert_array_equal(got, want)
