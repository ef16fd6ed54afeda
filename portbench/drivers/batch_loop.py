"""A closed loop of key frames in batches: each ``enc.encode_batch(frames)``
takes the next ``batch`` frames and starts when the one before it
returned, one call in flight, as an all-intra archive transfer that hands
the encoder several frames at once.  Session frame t is
``pool[t % len(pool)]``, a host array that the call uploads.  Every frame
is a key frame, so the configuration's ``gop`` is 1.
"""

import time

from portbench.harness import Call, RunFailed


def check(traffic: dict, config: dict):
    if config["gop"] != 1:
        raise RunFailed("encode_batch codes key frames: the configuration's "
                        f"gop is {config['gop']}, not 1")
    if traffic["pool"] % traffic["batch"]:
        raise RunFailed(f"a pool of {traffic['pool']} frames does not hold "
                        f"whole batches of {traffic['batch']}")


def drive(enc, pool: list, traffic: dict, first: int, n: int | None,
          until: float | None) -> list:
    """Batches from frame ``first`` on; stops after ``n`` calls, or at the
    first call that would start at or after ``until`` (host clock)."""
    calls, t, b = [], first, traffic["batch"]
    while n is None or len(calls) < n:
        t0 = time.perf_counter()
        if until is not None and t0 >= until:
            break
        idx = list(range(t, t + b))
        pkts = enc.encode_batch([pool[i % len(pool)] for i in idx])
        calls.append(Call(t0, time.perf_counter(), idx, pkts))
        t += b
    return calls
