"""The program adapter of the FFV1 configurations: all that the benchmark
takes from the program under test, the PyTorch and CUDA port
``ffmpeg_ffv2_tpu_torch``, on one CUDA card.  It gives the encoder session
(``DeviceFFV1Encoder``), the launch and plain-call counters of the port's
kernels, the kernels each coder's path launches, the names of the
library's kernels (read from its CUDA sources, so that the profile can
tell them from torch's), and the card's clock, memory and name.  The port
is imported here, on first use, and nowhere else in the benchmark.

A program adapter is a module ``portbench/programs/<name>.py`` with a
class ``Program`` that has these methods; a configuration names it under
``"program"``.
"""

import os
import re

_GLOBAL = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*\)"
                     r"\s+)?(?:void\s+)?(\w+)\s*\(")


class Program:
    """The port's encoder and counters, on ``cuda:0``."""

    DEVICE = "cuda"

    def __init__(self):
        import torch
        from ffmpeg_ffv2_tpu_torch import _build
        from ffmpeg_ffv2_tpu_torch.ffv1 import device_coder
        from ffmpeg_ffv2_tpu_torch.ffv1.params import FFV1Config
        self._torch = torch
        self._build = _build
        self._device_coder = device_coder
        self._config = FFV1Config

    def load(self):
        """Build (first run in a checkout) and load the kernel library."""
        self._build.load()

    def encoder(self, config: dict):
        """A ``DeviceFFV1Encoder`` session of ``config``, key frames every
        ``config["gop"]`` frames."""
        cfg = self._config(level=config["level"], coder=config["coder"],
                           context=config["context"], slices=config["slices"],
                           slicecrc=config["slicecrc"],
                           gop_size=config["gop"])
        return self._device_coder.DeviceFFV1Encoder(
            config["width"], config["height"], config["pix_fmt"], cfg,
            device=self.DEVICE)

    def path_kernels(self, enc) -> tuple:
        """The kernels that every frame of this session launches."""
        return tuple(enc.kernels)

    def launches(self) -> dict:
        return {k: v.launches for k, v in self._build.KERNELS.items()}

    def plain_calls(self) -> int:
        return sum(k.plain_calls for k in self._build.KERNELS.values())

    def library_kernels(self) -> set:
        """The names of the ``__global__`` functions of the library."""
        names = set()
        for f in os.listdir(self._build.CSRC):
            if f.endswith(".cu"):
                with open(os.path.join(self._build.CSRC, f)) as fh:
                    names.update(_GLOBAL.findall(fh.read()))
        return names

    # the card
    def sync(self):
        self._torch.cuda.synchronize()

    def peak_bytes(self) -> int:
        return self._torch.cuda.max_memory_allocated()

    def reset_peak(self):
        self._torch.cuda.reset_peak_memory_stats()

    def release(self):
        """Hand the freed session's memory back before the check."""
        self._torch.cuda.empty_cache()

    def activities(self) -> list:
        from torch.profiler import ProfilerActivity
        return [ProfilerActivity.CUDA]

    def device(self) -> dict:
        return {"platform": "gpu",
                "kind": self._torch.cuda.get_device_name(0), "count": 1}
