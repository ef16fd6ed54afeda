"""``python -m ffmpeg_ffv2_tpu_torch.cli`` against the JAX package's CLI:
every command's output files equal the original's byte for byte, on a
64x48 yuv420p clip of four frames (``-g 2``: key and inter frames).  The
JAX CLI runs once per command in subprocesses (a module fixture, as
``tests/test_cli.py`` runs it); the port's ``main(argv)`` runs in
process, and once as ``python -m``.  The ``tpu`` and ``device`` backends
run with ``-device cpu`` (their plain versions) and are held against the
JAX CLI's ``native`` output, which their packets equal; the port's
default backend is ``device``, the JAX CLI's ``native``."""

import concurrent.futures as cf
import os
import subprocess
import sys

import numpy as np
import pytest

from ffmpeg_ffv2_tpu_torch.cli.main import main
from ffmpeg_ffv2_tpu_torch.container import AviWriter
from test_torch_formats import torch_one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, N = 64, 48, 4
ENC = ["-s", f"{W}x{H}", "-slices", "4", "-g", "2"]


def _cli(module, *args):
    return subprocess.run([sys.executable, "-m", module, *args],
                          capture_output=True, text=True, cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO))


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """The raw clip: a moving gradient in luma, seeded noise in chroma."""
    td = tmp_path_factory.mktemp("torch_cli")
    rng = np.random.RandomState(0)
    path = td / "in.yuv"
    with open(path, "wb") as f:
        for t in range(N):
            y = ((np.indices((H, W)).sum(0) * 3 + t) % 256).astype(np.uint8)
            u = rng.randint(0, 256, (H // 2, W // 2)).astype(np.uint8)
            v = rng.randint(0, 256, (H // 2, W // 2)).astype(np.uint8)
            f.write(y.tobytes() + u.tobytes() + v.tobytes())
    return td, path


@pytest.fixture(scope="module")
def jax_cli(clip):
    """The JAX CLI's outputs (in ``td/jax``) and stdout, by command name;
    chains of commands that read an earlier one's file run in order,
    the chains side by side."""
    td, src = clip
    out = td / "jax"
    out.mkdir()
    i = str(src)

    def o(name):
        return str(out / name)

    chains = {
        "native": [["encode", "-i", i, *ENC, "-vstats", o("native.vstats"),
                    "-o", o("native.avi")],
                   ["decode", "-i", o("native.avi"), "-o", o("dec.yuv")],
                   ["decode", "-workers", "4", "-i", o("native.avi"),
                    "-o", o("dec4.yuv")],
                   ["info", "-i", o("native.avi")]],
        "ac": [["encode", "-i", i, *ENC, "-coder", "ac", "-o", o("ac.avi")]],
        "python": [["encode", "-i", i, *ENC, "--backend", "python",
                    "-o", o("python.avi")]],
        "mkv": [["encode", "-i", i, *ENC, "-coder", "ac", "-o", o("t.mkv")],
                ["decode", "-i", o("t.mkv"), "-o", o("mkv.yuv")],
                ["info", "-i", o("t.mkv")]],
        "nut": [["encode", "-i", i, *ENC, "-o", o("t.nut")],
                ["decode", "-i", o("t.nut"), "-o", o("nut.yuv")]],
        "twopass": [["encode", "-i", i, *ENC, "-coder", "ac", "-pass", "1",
                     "-passlogfile", o("pass"), "-o", o("p1.avi")],
                    ["encode", "-i", i, *ENC, "-coder", "ac", "-pass", "2",
                     "-passlogfile", o("pass"), "-o", o("p2.avi")]],
        "transcode": [["transcode", "-i", i, *ENC, "-keep", o("trans.avi"),
                       "-o", o("trans.yuv")]],
        "psnr": [["psnr", i, o("dec.yuv")]],
    }

    def run(chain):
        res = []
        for args in chain:
            r = _cli("ffmpeg_ffv2_tpu.cli", *args)
            assert r.returncode == 0, (args, r.stderr)
            res.append(r.stdout)
        return res

    with cf.ThreadPoolExecutor(4) as ex:
        futs = {k: ex.submit(run, c) for k, c in chains.items()
                if k != "psnr"}
        stdout = {k: f.result() for k, f in futs.items()}
    stdout["psnr"] = run(chains["psnr"])
    return out, stdout


def _port(td, *args):
    """The port's CLI in process, in ``td/torch``."""
    (td / "torch").mkdir(exist_ok=True)
    main([str(a) for a in args])
    return td / "torch"


@pytest.mark.parametrize("backend, coder, want", [
    ("native", "rice", "native.avi"), ("python", "rice", "python.avi"),
    ("tpu", "rice", "native.avi"), ("device", "rice", "native.avi"),
    ("device", "ac", "ac.avi")])
def test_torch_cli_encode_backends(clip, jax_cli, backend, coder, want):
    """Each backend's AVI equals the JAX CLI's: the native session and the
    Python codec their originals', TPUFFV1Encoder and DeviceFFV1Encoder
    (on the CPU) the native codec's, on Golomb-Rice and the range coder."""
    td, src = clip
    out = _port(td, "encode", "-i", src, *ENC, "-coder", coder,
                "--backend", backend, "-device", "cpu",
                "-o", td / "torch" / f"{backend}_{coder}.avi")
    assert ((out / f"{backend}_{coder}.avi").read_bytes()
            == (jax_cli[0] / want).read_bytes())


def test_torch_cli_vstats(clip, jax_cli):
    """-vstats writes the original's per-frame lines (bytes, bpp, slice
    sizes from the trailer walk, CRC status) and summary, on the default
    backend (device)."""
    td, src = clip
    out = _port(td, "encode", "-i", src, *ENC, "-device", "cpu", "-vstats",
                td / "torch" / "native.vstats", "-o",
                td / "torch" / "vstats.avi")
    assert ((out / "native.vstats").read_text()
            == (jax_cli[0] / "native.vstats").read_text())
    assert ((out / "vstats.avi").read_bytes()
            == (jax_cli[0] / "native.avi").read_bytes())


def test_torch_cli_two_pass(clip, jax_cli):
    """-pass 1 writes the original's AVI and statistics log, and -pass 2
    on that log the original's AVI."""
    td, src = clip
    log = td / "torch" / "pass"
    for n in (1, 2):
        out = _port(td, "encode", "-i", src, *ENC, "-coder", "ac", "-pass",
                    n, "-passlogfile", log, "-o", td / "torch" / f"p{n}.avi")
        assert ((out / f"p{n}.avi").read_bytes()
                == (jax_cli[0] / f"p{n}.avi").read_bytes())
    assert ((td / "torch" / "pass-0.log").read_text()
            == (jax_cli[0] / "pass-0.log").read_text())


@pytest.mark.parametrize("ext, coder", [("mkv", "ac"), ("nut", "rice")])
def test_torch_cli_containers(clip, jax_cli, ext, coder):
    """Matroska and NUT by the output's extension: the original's bytes;
    the port decodes the original's file to the input, as the original's
    decode does."""
    td, src = clip
    out = _port(td, "encode", "-i", src, *ENC, "-coder", coder,
                "-device", "cpu", "-o", td / "torch" / f"t.{ext}")
    assert ((out / f"t.{ext}").read_bytes()
            == (jax_cli[0] / f"t.{ext}").read_bytes())
    _port(td, "decode", "-i", jax_cli[0] / f"t.{ext}",
          "-o", out / f"{ext}.yuv")
    assert ((out / f"{ext}.yuv").read_bytes()
            == (jax_cli[0] / f"{ext}.yuv").read_bytes() == src.read_bytes())


@pytest.mark.parametrize("workers", [1, 4])
def test_torch_cli_decode(clip, jax_cli, workers):
    """decode, sequential and with -workers 4 (BatchedFFV1Decoder's
    frame-pipelined decode), of the original's AVI: the original's raw
    file, which is the input."""
    td, src = clip
    name = "dec.yuv" if workers == 1 else "dec4.yuv"
    out = _port(td, "decode", "-workers", workers,
                "-i", jax_cli[0] / "native.avi", "-o", td / "torch" / name)
    assert ((out / name).read_bytes() == (jax_cli[0] / name).read_bytes()
            == src.read_bytes())


def test_torch_cli_transcode(clip, jax_cli):
    """transcode keeps the original's container (-keep) and gives its
    raw output, the input."""
    td, src = clip
    out = _port(td, "transcode", "-i", src, *ENC, "-device", "cpu", "-keep",
                td / "torch" / "trans.avi", "-o", td / "torch" / "trans.yuv")
    for name in ("trans.avi", "trans.yuv"):
        assert (out / name).read_bytes() == (jax_cli[0] / name).read_bytes()
    assert (out / "trans.yuv").read_bytes() == src.read_bytes()


def test_torch_cli_psnr_and_info(clip, jax_cli, capsys):
    """psnr prints the original's tiny_psnr line (PSNR:999.99 on a lossless
    decode) and info its stream and FFV1 lines, AVI and Matroska."""
    td, src = clip
    out, stdout = jax_cli
    capsys.readouterr()
    main(["psnr", str(src), str(out / "dec.yuv")])
    line = capsys.readouterr().out
    assert line == stdout["psnr"][0] and "PSNR:999.99" in line
    for name, chain, step in (("native.avi", "native", 3),
                              ("t.mkv", "mkv", 2)):
        main(["info", "-i", str(out / name)])
        got = capsys.readouterr().out
        assert got == stdout[chain][step]
        assert "ffv1: version 3.4" in got


def test_torch_cli_module_entry(clip, jax_cli):
    """``python -m ffmpeg_ffv2_tpu_torch.cli`` runs: its encode (the
    default backend, device, on ``-device cpu``) equals the JAX CLI's, and
    the defaults (``--backend device -device cuda``) where torch sees no
    card exit non-zero with the encoder's error, no fallback to the
    CPU."""
    td, src = clip
    out = td / "torch" / "entry.avi"
    out.parent.mkdir(exist_ok=True)
    r = _cli("ffmpeg_ffv2_tpu_torch.cli", "encode", "-i", str(src), *ENC,
             "-device", "cpu", "-o", str(out))
    assert r.returncode == 0, r.stderr
    assert out.read_bytes() == (jax_cli[0] / "native.avi").read_bytes()
    r = _cli("ffmpeg_ffv2_tpu_torch.cli", "encode", "-i", str(src), *ENC,
             "-o", str(td / "torch" / "cuda.avi"))
    assert r.returncode != 0
    assert "sees no CUDA device" in r.stderr
    assert not (td / "torch" / "cuda.avi").exists()


@pytest.mark.parametrize("case", ["codec", "ffv2", "mesh", "ffv2_decode",
                                  "qp", "block_size", "workers"])
def test_torch_cli_errors(clip, case):
    """An unknown codec exits non-zero; -c ffv2, --mesh and an FFV2 stream
    to decode exit non-zero naming the roadmap item that ports them; the
    FFV2-only options (-qp, -block_size, encode's -workers) are not
    options of the port's encode yet, and argparse rejects them."""
    td, src = clip
    (td / "torch").mkdir(exist_ok=True)
    enc = ["encode", "-i", str(src), *ENC, "-o", str(td / "torch" / "x.avi")]
    argv = {"codec": enc + ["-c", "vp9"], "ffv2": enc + ["-c", "ffv2"],
            "mesh": enc + ["--mesh", "2x2"], "qp": enc + ["-qp", "20"],
            "block_size": enc + ["-block_size", "0"],
            "workers": enc + ["-workers", "4"]}.get(case)
    if case == "ffv2_decode":
        avi = AviWriter(W, H, "FFV2", (25, 1), b"")
        avi.write_packet(b"\0" * 16, True)
        avi.save(str(td / "torch" / "ffv2.avi"))
        argv = ["decode", "-i", str(td / "torch" / "ffv2.avi"),
                "-o", str(td / "torch" / "ffv2.yuv")]
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code not in (0, None)
    if case in ("ffv2", "mesh", "ffv2_decode"):
        assert "ROADMAP.md queue 1 item 2" in str(e.value.code)
