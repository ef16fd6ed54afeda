"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  The last line of standard output is the result (JSON); the numbers
that decided ``correct`` are the last lines of standard error.  Exits
with 1 and prints no result where there is no card, where the run fails a
guard, or where anything raises.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    # torch's own runtime-compiled kernels (NVRTC) cache in the checkout too
    os.environ.setdefault("PYTORCH_KERNEL_CACHE_PATH",
                          os.path.join(ROOT, "build", "torch_kernel_cache"))
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    try:
        from portbench import harness
        cell = harness.load_cell(a.workload)
        import torch
        if not torch.cuda.is_available():
            raise harness.RunFailed("torch sees no CUDA device")
        if torch.cuda.device_count() < cell.chips:
            raise harness.RunFailed(
                f"the cell asks for {cell.chips} cards, torch sees "
                f"{torch.cuda.device_count()}")
        torch.cuda.init()
        # one host thread for torch's own CPU ops: the port's host work is
        # Python, numpy and its C runtime; fewer threads, steadier runs
        torch.set_num_threads(1)
        print(f"device: {torch.cuda.get_device_name(0)}, count "
              f"{torch.cuda.device_count()}, nvidia-smi name,power.limit: "
              f"{harness.power_limit()}", file=sys.stderr, flush=True)
        out = harness.run_cell(cell, a.seed, a.seconds, bool(a.trace),
                               t_start=T_START)
    except Exception:
        traceback.print_exc()
        return 1
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
