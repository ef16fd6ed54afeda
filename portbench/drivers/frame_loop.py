"""A closed loop of one frame a call: each ``enc.encode(frame)`` starts
when the one before it returned, one frame in flight, as a capture or
transcode pipeline that waits for each packet hands them over.  Session
frame t is ``pool[t % len(pool)]``, a host array that the call uploads;
key frames fall every ``gop`` frames of the configuration.

A driver loop is a module ``portbench/drivers/<name>.py`` with
``check(traffic, config)`` and ``drive(enc, pool, traffic, first, n,
until)``; a traffic mix names it under ``"driver"``.
"""

import time

from portbench.harness import Call, RunFailed


def check(traffic: dict, config: dict):
    """The pool must hold whole GOPs, so that pool frame t % len(pool)
    always sits at the same place in its GOP."""
    if traffic["pool"] % max(config["gop"], 1):
        raise RunFailed(f"a pool of {traffic['pool']} frames does not hold "
                        f"whole GOPs of {config['gop']}")


def drive(enc, pool: list, traffic: dict, first: int, n: int | None,
          until: float | None) -> list:
    """Frames ``first``, ``first + 1``, ...; stops after ``n`` calls, or
    at the first call that would start at or after ``until`` (host
    clock)."""
    calls, t = [], first
    while n is None or len(calls) < n:
        t0 = time.perf_counter()
        if until is not None and t0 >= until:
            break
        pkt = enc.encode(pool[t % len(pool)])
        calls.append(Call(t0, time.perf_counter(), [t], [pkt]))
        t += 1
    return calls
