"""The PyTorch twin of the repository's ``__graft_entry__.py``: the
single-device step and the multi-device dry run, on the port.

``entry(device)`` gives the JAX entry's step, one FFV1 phase-A pass
(``ffv1.phase_a.plane_context_diff``) over a 1080p luma plane batch, and
its example arguments on ``device``.

``dryrun_multichip(n_devices, device)`` runs the JAX dry run's config
matrix through the port's public multi-device API
(``parallel.ffv1.ParallelFFV1Encoder``, ``parallel.ffv2.
encode_front_q_sharded``) on a gloo world of ``n_devices`` ranks
(``parallel.world.spawn_world`` with the rank program
``parallel.world.run_cases``).  Rank r runs on card r mod the card
count, or, with ``device="cpu"``, runs the kernels' plain versions on the
host.  Every
FFV1 packet must equal the port's host ``ffv1.encoder.FFV1Encoder`` on the
same lane and decode losslessly on ``ffv1.decoder.FFV1Decoder``; the
sharded FFV2 front must equal ``ffv2.device.encode_front_q``.

    python -m ffmpeg_ffv2_tpu_torch.graft_entry [--device cpu] [--ranks N]
"""

from __future__ import annotations

import time

import numpy as np
import torch

DRYRUN_TIMEOUT_S = 600.0        # the world's deadline (spawn_world)


def entry(device="cuda"):
    """(fn, example): ``fn(planes)`` is one FFV1 phase-A step on int32
    [S, H, W] stacked slice crops, returning int32 (ctx, diff) shaped like
    them; ``example`` is its argument tuple, one int32 (4, 540, 960)
    tensor of zeros on ``device`` (the JAX entry's example)."""
    from .ffv1.params import FFV1Config, params_from_config
    from .ffv1.phase_a import _wrap16, lut_for, plane_context_diff

    p = params_from_config(FFV1Config(slices=4), "yuv420p", 1920, 1080)
    qt = lut_for(p, 0)

    def step(planes):
        # the JAX step vmaps plane_context_diff over the crops; the
        # port's takes the batch in one call
        return plane_context_diff(_wrap16(planes.to(torch.int32)), qt, 8,
                                  False)

    example = (torch.zeros((4, 540, 960), dtype=torch.int32,
                           device=device),)
    return step, example


def dryrun_lanes(pix: str, coder: int, wh, data: int, inter: bool):
    """The JAX dry run's frames (``__graft_entry__._run_config``):
    lanes[b][t] = the planes of lane b's frame t, FATE-style gradients and
    mild seeded noise."""
    w, h = wh
    rgb = pix == "bgr0"
    rng = np.random.RandomState(7 + coder + (43 if rgb else 0))

    def plane(ph, pw, k, t=0):
        yy, xx = np.mgrid[0:ph, 0:pw]
        base = ((xx * (2 + k) + yy * (3 + k) + 5 * t) % 256) // 8 * 8
        return (base + rng.randint(0, 4, (ph, pw))).astype(np.int32) & 0xFF

    n_frames = 2 if inter else 1
    lanes = []
    for _ in range(data):
        if rgb:
            lanes.append([[plane(h, w, k, t) for k in range(3)]
                          for t in range(n_frames)])
        else:
            ch, cw = (h + 1) // 2, (w + 1) // 2   # ceil: odd frame sizes
            lanes.append([[plane(h, w, 0, t), plane(ch, cw, 1, t),
                           plane(ch, cw, 2, t)]
                          for t in range(n_frames)])
    return lanes


def dryrun_ffv2_plane(n_devices: int) -> np.ndarray:
    """The JAX dry run's FFV2 frame: one gray plane [1, 64 n, 64], a
    superblock row a rank."""
    rng = np.random.RandomState(5)
    yy, xx = np.mgrid[0:n_devices * 64, 0:64]
    return (((xx * 2 + yy * 3) % 256) // 8 * 8
            + rng.randint(0, 4, yy.shape)).astype(np.int32)[None] & 0xFF


def dryrun_configs(n_devices: int) -> list:
    """The JAX dry run's config matrix on ``n_devices`` ranks: dicts of
    name, mesh (data, slices), pix, coder, wh, n_slices, inter.  JAX's
    ``use_pallas=True`` config has no counterpart here: the port's kernels
    are its only device path."""
    data = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    n_shards = n_devices // data
    if 16 % n_shards != 0:         # slice grids come from a fixed set
        data, n_shards = 1, n_devices
    if 16 % n_shards != 0:
        data, n_shards = n_devices, 1
    mesh = (data, n_shards)
    base = dict(mesh=mesh, wh=(64, 32), n_slices=16, inter=False)
    configs = [dict(base, pix="yuv420p", coder=1, inter=True),  # key+inter
               dict(base, pix="yuv420p", coder=0),
               dict(base, pix="bgr0", coder=1)]
    if n_shards in (1, 2):
        # non-uniform geometry: 36x33 at 2x2 slices splits into two
        # uniform shape banks (luma rows 16 vs 17)
        configs.append(dict(base, pix="yuv420p", coder=1, wh=(36, 33),
                            n_slices=4))
    if n_devices % 4 == 0 and 16 % (n_devices // 4) == 0:
        # 4 data lanes, Golomb-Rice, another geometry
        configs.append(dict(base, mesh=(4, n_devices // 4), pix="yuv420p",
                            coder=0, wh=(96, 64)))
    for c in configs:
        c["name"] = (f"{c['pix']}/coder{c['coder']}/{c['wh'][0]}x"
                     f"{c['wh'][1]}/data{c['mesh'][0]}x slice{c['mesh'][1]}")
    return configs


def _check_ffv1(c, lanes, results):
    """Every lane's packets against the host encoder, every rank's against
    rank 0's, and the lossless decode.  Returns packets[b][t]."""
    from .ffv1.decoder import FFV1Decoder
    from .ffv1.encoder import FFV1Encoder
    from .ffv1.params import FFV1Config
    r0 = results[0]
    if any(r["digests"] != r0["digests"] for r in results):
        raise AssertionError(f"{c['name']}: the ranks' packets differ")
    w, h = c["wh"]
    cfg = FFV1Config(level=3, coder=c["coder"], slices=c["n_slices"],
                     slicecrc=1)
    packets = [[step[b] for step in r0["packets"]] for b in range(len(lanes))]
    for b, frames in enumerate(lanes):
        e = FFV1Encoder(w, h, c["pix"], cfg)
        dec = FFV1Decoder(w, h, e.extradata)
        for t, planes in enumerate(frames):
            ref = e.encode(planes, t == 0)
            if packets[b][t] != ref:
                raise AssertionError(
                    f"{c['name']} lane {b} frame {t}: sharded packet != "
                    f"reference ({len(packets[b][t])} vs {len(ref)} bytes)")
            for a, x in zip(dec.decode(ref), planes):
                if not np.array_equal(np.asarray(a), x):
                    raise AssertionError(f"{c['name']} lane {b} frame {t}: "
                                         "decode mismatch")
    return packets


def dryrun_multichip(n_devices: int, device="cuda",
                     timeout_s: float = DRYRUN_TIMEOUT_S) -> dict:
    """The sharded dry run on a gloo world of ``n_devices`` ranks; raises
    AssertionError on any mismatch.  Returns, by config name, a dict of
    ``packets`` (FFV1: packets[lane][frame]) or ``front`` (FFV2: rank 0's
    (dc, pulses, igain)), with each rank's ``launches`` and
    ``plain_calls`` (the kernels' counts on that config), ``ms`` (its
    frames' or calls' host ms) and ``started`` (its start's marks,
    ``run_cases``)."""
    from .ffv1.params import FFV1Config
    from .ffv2 import device as dv
    from .ffv2 import dsp
    from .parallel.world import run_cases, spawn_world

    configs = dryrun_configs(n_devices)
    lanes = {c["name"]: dryrun_lanes(c["pix"], c["coder"], c["wh"],
                                     c["mesh"][0], c["inter"])
             for c in configs}
    cases = [dict(kind="ffv1", name=c["name"], mesh=c["mesh"],
                  width=c["wh"][0], height=c["wh"][1], pix_fmt=c["pix"],
                  cfg=FFV1Config(level=3, coder=c["coder"],
                                 slices=c["n_slices"], slicecrc=1),
                  lanes=lanes[c["name"]],
                  keyframes=[t == 0 for t in range(2 if c["inter"] else 1)])
             for c in configs]
    # FFV2: the SB-row-banded front over all the ranks, its 32-px halo
    # gathered between neighbours
    pl2 = dryrun_ffv2_plane(n_devices)
    ffv2_name = f"ffv2/gray/{pl2.shape[2]}x{pl2.shape[1]}/slice{n_devices}"
    cases.append(dict(kind="ffv2", name=ffv2_name, mesh=(1, n_devices),
                      planes=pl2, depth=8, qp=16))
    t0 = time.perf_counter()
    res = spawn_world(run_cases, n_devices, "gloo", timeout_s, cases, device)
    world_s = time.perf_counter() - t0
    out = {}
    for i, c in enumerate(cases):
        results = [r[i] for r in res]
        rec = dict(launches=[r["launches"] for r in results],
                   plain_calls=[r["plain"] for r in results],
                   started=[r["started"] for r in results])
        if c["kind"] == "ffv1":
            rec["packets"] = _check_ffv1(configs[i], lanes[c["name"]],
                                         results)
            rec["ms"] = [r["frame_ms"] for r in results]
        else:
            if any(r["digest"] != results[0]["digest"] for r in results):
                raise AssertionError(f"{c['name']}: the ranks' fronts "
                                     "differ")
            ref = dv.encode_front_q(pl2, 8, 16,
                                    list(dsp.band_starts(dsp.SB_SIZE)),
                                    device=device)
            got = results[0]["result"]
            if not all(np.array_equal(a, b) for a, b in zip(ref, got)):
                raise AssertionError("ffv2 sharded front != single-device "
                                     "front")
            rec["front"] = got
            rec["ms"] = [r["ms"] for r in results]
        out[c["name"]] = rec
        print(f"dryrun config {c['name']} ok", flush=True)
    print(f"dryrun_multichip OK: {n_devices} ranks (gloo, device {device}) "
          f"in {world_s:.1f} s; configs [{', '.join(out)}] all "
          "byte-identical to the reference encoder and lossless (ffv2: "
          "sharded front == single-device front)", flush=True)
    return out


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=4)
    a = ap.parse_args()
    fn, args = entry(a.device)
    ctx, diff = fn(*args)
    print(f"entry: ctx {tuple(ctx.shape)} {ctx.dtype}, diff "
          f"{tuple(diff.shape)} {diff.dtype} on {ctx.device}")
    dryrun_multichip(a.ranks, a.device)
