"""Stand-ins for the program under test.

``CpuPort`` is the port on the CPU, on its plain versions, with no
counters: the CPU tests drive whole runs through it.  The others must make
``correct`` false: the control (the plain reference coding 7-bit samples,
the step below the 8 bits the configurations state), and the port with a
fault planted in what its timed path returns.  ``test_portbench_faults.py``
runs them at a small size on the CPU; ``python3 -m portbench.tests.faults``
runs them at a cell's own size, the faults on a machine with a card:

    python3 -m portbench.tests.faults --workload range-1080p-stream \
        --seeds 11,12,13 --seconds 5 --fault control
"""

import argparse
import json
import sys

import numpy as np

from portbench import harness
from portbench.programs.ffv1_device import Program
from portbench.reference.ffv1 import RefFFV1Encoder

FAULTS = ("control", "stale_state", "half_batch", "altered_byte")


class _Host:
    """No card: nothing to sync, no memory counted, no counters."""

    def load(self):
        pass

    def path_kernels(self, enc):
        return ()

    def launches(self):
        return {}

    def plain_calls(self):
        return 0

    def library_kernels(self):
        return set()

    def sync(self):
        pass

    def peak_bytes(self):
        return 0

    def reset_peak(self):
        pass

    def release(self):
        pass

    def activities(self):
        from torch.profiler import ProfilerActivity
        return [ProfilerActivity.CPU]    # a trace with no device events

    def device(self):
        return {"platform": "cpu", "kind": "cpu", "count": 0}


class CpuPort(_Host, Program):
    """The port's encoder on the CPU (its kernels' plain versions)."""

    DEVICE = "cpu"


class _ControlEncoder:
    """The reference in the program's place, on samples with their lowest
    bit cleared (7-bit precision)."""

    def __init__(self, config: dict):
        c = config
        self.ref = RefFFV1Encoder(c["width"], c["height"], c["slices"],
                                  c["coder"], c["gop"], c["context"])

    def encode(self, planes):
        return self.ref.encode([np.asarray(p) & 0xFE for p in planes])

    def encode_batch(self, frames):
        return [self.encode(f) for f in frames]


class Control(_Host):
    """A program whose encoder is the 7-bit control."""

    def encoder(self, config):
        return _ControlEncoder(config)


class _Faulty:
    """The port's encoder with one fault planted in what it returns."""

    def __init__(self, enc, fault: str):
        self.enc, self.fault = enc, fault
        self.kernels = enc.kernels

    def encode(self, planes):
        if self.fault == "stale_state":
            # the step hands back the context states it was given
            keep = {k: getattr(self.enc, k).clone()
                    for k in ("canonical", "vcanon") if hasattr(self.enc, k)}
            pkt = self.enc.encode(planes)
            for k, v in keep.items():
                setattr(self.enc, k, v)
            return pkt
        return self._alter([self.enc.encode(planes)])[0]

    def encode_batch(self, frames):
        pkts = self.enc.encode_batch(frames)
        if self.fault == "half_batch":
            return pkts[:len(pkts) // 2]
        return self._alter(pkts)

    def _alter(self, pkts):
        if self.fault != "altered_byte":
            return pkts
        p = bytearray(pkts[0])
        p[len(p) // 2] ^= 0x01
        return [bytes(p)] + pkts[1:]


class Faulty:
    """``base`` (a program adapter or a stand-in), each of its encoders
    wrapped with ``fault``."""

    def __init__(self, base, fault: str):
        self.base, self.fault = base, fault

    def __getattr__(self, name):
        return getattr(self.base, name)

    def encoder(self, config):
        return _Faulty(self.base.encoder(config), self.fault)


def program_for(fault: str, base=None):
    """The control, or ``base`` (the port on the card by default) with
    ``fault`` planted."""
    if fault == "control":
        return Control()
    return Faulty(base if base is not None else Program(), fault)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--fault", choices=FAULTS, default="control")
    a = ap.parse_args(argv)
    cell = harness.load_cell(a.workload)
    for seed in (int(s) for s in a.seeds.split(",")):
        out = harness.run_cell(cell, seed, a.seconds, False,
                               program=program_for(a.fault))
        print(json.dumps({"workload": a.workload, "fault": a.fault,
                          "seed": seed, "correct": out["correct"],
                          "checks": out["checks"],
                          "attempted": out["attempted"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
