"""Copy of ``ffmpeg_ffv2_tpu/ffv1/batched.py``.

Frame-pipelined FFV1 decode.

The reference overlaps frames with frame threads plus per-slice progress
sync (pthread_frame.c:473,558; ffv1dec.c:1042-1085 update_thread_context)
because its decoder contexts carry adaptive state across non-key frames.
Two expressions of that dependency structure live here:

* slice-column pipelining (default, v>=3): the native runtime streams
  each slice column through ALL frames — slice s of frame t+1 runs
  right after slice s of frame t on the same worker, which is exactly
  the constraint the reference's await/report dance enforces, with zero
  synchronisation and cache-hot context state.  Consecutive *inter*
  frames decode concurrently; no GOP boundaries required.  See
  Codec::decode_frames_pipelined (native/ffv1_runtime.cpp).

* GOP batching (v<3 fallback): keyframes reset every slice's contexts
  (ffv1.c:182), so GOPs are independent decode units; workers decode
  whole GOPs in parallel, each driving its own native session.
"""

from __future__ import annotations

import concurrent.futures as cf

import numpy as np

from .params import FFV1Params
from .native import NativeFFV1Codec


class BatchedFFV1Decoder:
    """Decode a packet sequence with GOP-level parallelism.

    n_workers: parallel GOP pipelines (default: os.cpu_count()).
    n_slice_threads: slice threads per pipeline (native pool).
    """

    def __init__(self, p: FFV1Params, n_workers: int = 0,
                 n_slice_threads: int = 0, mode: str = "auto"):
        import os
        self.p = p
        self.n_workers = n_workers or (os.cpu_count() or 1)
        self.n_slice_threads = n_slice_threads
        # slice-column pipelining subsumes GOP batching for v>=3 (the
        # in-packet slice region table lets slices decode independently)
        self.mode = ("pipeline" if p.version >= 3 else "gop") \
            if mode == "auto" else mode
        if self.mode == "pipeline":
            self._sessions = [NativeFFV1Codec(
                p, n_slice_threads or self.n_workers)]
        else:
            self._sessions = [NativeFFV1Codec(p, n_slice_threads)
                              for _ in range(self.n_workers)]

    @staticmethod
    def split_gops(packets, keyflags):
        """[(start, end)) ranges of independent decode units."""
        gops = []
        start = 0
        for i, k in enumerate(keyflags):
            if k and i > start:
                gops.append((start, i))
                start = i
            if k and i == 0:
                start = 0
        gops.append((start, len(packets)))
        return [g for g in gops if g[0] < g[1]]

    def decode_all(self, packets, keyflags=None):
        """Decode every packet; returns frames in presentation order.

        keyflags: per-packet keyframe booleans (container metadata);
        None = probe from each packet's first rac bit is NOT possible
        without decoding, so default assumes packet 0 starts a GOP and
        relies on the container flags for the rest."""
        if self.mode == "pipeline":
            # keyframe bits live in the bitstream; flags not needed
            return self._sessions[0].decode_pipelined(packets)
        if keyflags is None:
            keyflags = [i == 0 for i in range(len(packets))]
        gops = self.split_gops(packets, keyflags)
        out = [None] * len(packets)

        def run_worker(widx, worker_gops):
            dec = self._sessions[widx]
            res = []
            for (s, e) in worker_gops:
                # fresh state per GOP: the first packet is a keyframe,
                # which resets every slice's contexts on decode
                for t in range(s, e):
                    res.append((t, [np.asarray(pl) for pl in
                                    dec.decode(packets[t])]))
            return res

        buckets = [gops[w::self.n_workers] for w in range(self.n_workers)]
        buckets = [b for b in buckets if b]
        if len(buckets) == 1:
            results = [run_worker(0, buckets[0])]
        else:
            with cf.ThreadPoolExecutor(len(buckets)) as ex:
                futs = [ex.submit(run_worker, w, b)
                        for w, b in enumerate(buckets)]
                results = [f.result() for f in futs]
        for res in results:
            for t, fr in res:
                out[t] = fr
        return out
