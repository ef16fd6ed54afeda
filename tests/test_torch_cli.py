"""``python -m ffmpeg_ffv2_tpu_torch.cli`` against the JAX package's CLI:
every command's output files equal the original's byte for byte, on a
64x48 yuv420p clip of four frames (``-g 2``: key and inter frames) and,
for FFV2, a 64x48 yuv444p clip of four frames.  The JAX CLI runs once per
command in subprocesses (a module fixture, as ``tests/test_cli.py`` runs
it); the port's ``main(argv)`` runs in process, and once as ``python
-m``.  The ``tpu`` and ``device`` backends, FFV2 and ``--mesh`` run with
``-device cpu`` (their plain versions) and are held against the JAX
CLI's output; the port's default backend is ``device``, the JAX CLI's
``native``, whose packets it equals.  ``--mesh 2x2`` runs a gloo world of
4 CPU ranks; with Golomb-Rice it is held against the JAX CLI's ``--mesh
2x2`` on the virtual 8-device CPU mesh (tests/conftest.py), with the range
coder against the JAX CLI's single-device AVI, which the JAX CLI's
``--mesh`` writes too (its range-coder mesh compiles for minutes on this
CPU)."""

import concurrent.futures as cf
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from ffmpeg_ffv2_tpu_torch.cli.main import main
from test_torch_formats import torch_one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, N = 64, 48, 4
ENC = ["-s", f"{W}x{H}", "-slices", "4", "-g", "2"]
FFV2 = ["-s", f"{W}x{H}", "-pix_fmt", "yuv444p", "-c", "ffv2", "-qp", "16"]


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
def clip444(clip):
    """The FFV2 clip, yuv444p: a moving gradient in luma, seeded noise in
    chroma (beside ``clip``'s file)."""
    td, _ = clip
    rng = np.random.RandomState(1)
    path = td / "in444.yuv"
    with open(path, "wb") as f:
        for t in range(N):
            y = ((np.indices((H, W)).sum(0) * 3 + t) % 256).astype(np.uint8)
            f.write(y.tobytes() + rng.randint(0, 256, (2, H, W)).astype(
                np.uint8).tobytes())
    return path


@pytest.fixture(scope="module")
def jax_cli(clip, clip444):
    """The JAX CLI's outputs (in ``td/jax``) and stdout, by command name;
    chains of commands that read an earlier one's file run in order,
    the chains side by side."""
    td, src = clip
    out = td / "jax"
    out.mkdir()
    i = str(src)
    e2 = ["-i", str(clip444), *FFV2]

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
        "ffv2": [["encode", *e2, "-o", o("ffv2.avi")],
                 ["decode", "-i", o("ffv2.avi"), "-o", o("ffv2.yuv")]],
        "ffv2_bs0": [["encode", *e2, "-block_size", "0",
                      "-o", o("ffv2_bs0.avi")]],
        "ffv2_python": [["encode", *e2, "--backend", "python",
                         "-o", o("ffv2_python.avi")]],
        "ffv2_workers": [["encode", *e2, "-workers", "4",
                          "-o", o("ffv2_workers.avi")]],
        "ffv2_transcode": [["transcode", *e2, "-block_size", "0", "-keep",
                            o("ffv2_trans.avi"), "-o", o("ffv2_trans.yuv")]],
        "mesh": [["encode", "-i", i, *ENC, "--mesh", "2x2",
                  "-o", o("mesh_rice.avi")]],
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
    backend (device, Golomb-Rice), and adds the device session's stages:
    each frame's ``stages_ms`` (every stage of its ``encode`` call) and,
    beside the summary, each stage's total ms and count over the
    frames."""
    from ffmpeg_ffv2_tpu_torch.utils.metrics import STAGE_KINDS
    td, src = clip
    out = _port(td, "encode", "-i", src, *ENC, "-device", "cpu", "-vstats",
                td / "torch" / "native.vstats", "-o",
                td / "torch" / "vstats.avi")
    got = [json.loads(x) for x in
           (out / "native.vstats").read_text().splitlines()]
    want = [json.loads(x) for x in
            (jax_cli[0] / "native.vstats").read_text().splitlines()]
    frames, stages = [g.pop("stages_ms") for g in got[:-1]], got[-1].pop(
        "stages")
    assert got == want and len(frames) == N
    for st in frames:
        assert set(st) <= set(STAGE_KINDS)
        assert {"upload", "phase_a", "K5 vlc", "sizes to host",
                "bytes to host", "slice bytes",
                "slice trailers + CRC"} <= set(st)
        assert all(v >= 0 for v in st.values())
    assert set(stages) == set().union(*frames)
    assert stages["slice trailers + CRC"]["count"] == N
    assert stages["upload"]["ms"] == pytest.approx(
        sum(st["upload"] for st in frames), abs=1e-2)
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


@pytest.mark.parametrize("case", ["codec"])
def test_torch_cli_errors(clip, case):
    """An unknown codec exits non-zero."""
    td, src = clip
    (td / "torch").mkdir(exist_ok=True)
    enc = ["encode", "-i", str(src), *ENC, "-o", str(td / "torch" / "x.avi")]
    argv = {"codec": enc + ["-c", "vp9"]}[case]
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code not in (0, None)


@pytest.mark.parametrize("args, want", [
    (["-block_size", "64"], "ffv2.avi"),
    (["-block_size", "0"], "ffv2_bs0.avi"),
    (["--backend", "python"], "ffv2_python.avi")])
def test_torch_cli_ffv2_encode(clip, clip444, jax_cli, args, want):
    """-c ffv2 -qp 16 writes the original's AVI: NativeFFV2Encoder on the
    CPU (its plain versions) with the monolithic 64x64 superblocks and
    with the activity-adaptive split tree (-block_size 0), and the Python
    codec (--backend python)."""
    td, _ = clip
    name = "ffv2_" + "_".join(a.strip("-") for a in args) + ".avi"
    out = _port(td, "encode", "-i", clip444, *FFV2, *args, "-device", "cpu",
                "-o", td / "torch" / name)
    assert (out / name).read_bytes() == (jax_cli[0] / want).read_bytes()


def test_torch_cli_ffv2_workers(clip, clip444, jax_cli):
    """-c ffv2 -workers 4 (PipelinedFFV2Encoder, four frames in flight)
    writes the original's pipelined AVI, which is the sequential one."""
    td, _ = clip
    out = _port(td, "encode", "-i", clip444, *FFV2, "-workers", "4",
                "-device", "cpu", "-o", td / "torch" / "ffv2_workers.avi")
    want = (jax_cli[0] / "ffv2_workers.avi").read_bytes()
    assert (out / "ffv2_workers.avi").read_bytes() == want
    assert want == (jax_cli[0] / "ffv2.avi").read_bytes()


def test_torch_cli_ffv2_decode(clip, jax_cli):
    """decode -device cpu of the original's FFV2 AVI (NativeFFV2Decoder's
    plain versions) writes the original's raw file."""
    td, _ = clip
    out = _port(td, "decode", "-device", "cpu", "-i",
                jax_cli[0] / "ffv2.avi", "-o", td / "torch" / "ffv2.yuv")
    assert ((out / "ffv2.yuv").read_bytes()
            == (jax_cli[0] / "ffv2.yuv").read_bytes())


def test_torch_cli_ffv2_transcode(clip, clip444, jax_cli):
    """FFV2 transcode with the split tree keeps the original's container
    and writes its raw output; the decode runs on the encode's -device."""
    td, _ = clip
    out = _port(td, "transcode", "-i", clip444, *FFV2, "-block_size", "0",
                "-device", "cpu", "-keep", td / "torch" / "ffv2_trans.avi",
                "-o", td / "torch" / "ffv2_trans.yuv")
    for name in ("ffv2_trans.avi", "ffv2_trans.yuv"):
        assert (out / name).read_bytes() == (jax_cli[0] / name).read_bytes()


@pytest.mark.parametrize("coder, want", [("rice", "mesh_rice.avi"),
                                         ("ac", "ac.avi")])
def test_torch_cli_mesh(clip, jax_cli, capfd, coder, want):
    """--mesh 2x2 -device cpu: a gloo world of 4 ranks (two GOP lanes of
    two slice ranks) writes the original's AVI, Golomb-Rice the JAX CLI's
    --mesh 2x2 and range its single-device AVI; every rank ran its path's
    plain versions, and the transport is named on stderr."""
    import json
    td, src = clip
    capfd.readouterr()
    out = _port(td, "encode", "-i", src, *ENC, "-coder", coder, "--mesh",
                "2x2", "--backend", "native", "-device", "cpu",
                "-o", td / "torch" / f"mesh_{coder}.avi")
    assert ((out / f"mesh_{coder}.avi").read_bytes()
            == (jax_cli[0] / want).read_bytes())
    err = capfd.readouterr().err
    assert "--mesh 2x2: 4 ranks on gloo (-device cpu)" in err
    ranks = json.loads(err.split("--mesh ranks: ")[1].splitlines()[0])
    path = {"rice": ["place", "vlc", "ladder"],
            "ac": ["place", "adapt", "emission_pack", "expand",
                   "rac_render"]}[coder]
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    for r in ranks:
        assert r["transport"] == "gloo" and not r["launches"]
        assert all(r["plain_calls"].get(k, 0) > 0 for k in path), r
        assert set(r["start_s"]) == {"interpreter", "group", "device"}
        assert min(r["start_s"].values()) >= 0 and r["setup_ms"] > 0


@pytest.mark.parametrize("n_ranks, device, cards, want", [
    (4, "cpu", 8, "gloo"), (4, "cuda", 1, "gloo"), (1, "cuda", 1, "nccl"),
    (4, "cuda", 4, "nccl")])
def test_torch_cli_mesh_transport(monkeypatch, n_ranks, device, cards,
                                  want):
    """--mesh's transport: gloo on the CPU or where the ranks outnumber
    the cards torch sees (they share them), NCCL where every rank has a
    card of its own."""
    import torch
    from ffmpeg_ffv2_tpu_torch.cli.mesh import pick_transport
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert pick_transport(n_ranks, device) == want


@pytest.mark.parametrize("mesh, message", [
    ("3x3", "not divisible by slice-axis size 3"),
    ("2x", "is not DxS")])
def test_torch_cli_bad_mesh(clip, mesh, message):
    """A mesh the frame's slices do not allow (3x3 over 4 slices), or no
    DxS at all, exits non-zero with the reason before any rank starts."""
    td, src = clip
    (td / "torch").mkdir(exist_ok=True)
    with pytest.raises(SystemExit) as e:
        main(["encode", "-i", str(src), *ENC, "--mesh", mesh, "-device",
              "cpu", "-o", str(td / "torch" / "bad.avi")])
    assert e.value.code not in (0, None)
    assert message in str(e.value.code)
    assert not (td / "torch" / "bad.avi").exists()
