"""Multi-device encoders on torch.distributed (the counterpart of
``ffmpeg_ffv2_tpu/parallel``): ``slices`` (the mesh of ranks, sharded
phase A, the slice-bytes gather), ``ffv1.ParallelFFV1Encoder``,
``ffv2.encode_front_q_sharded`` and ``world.spawn_world`` (a world of
ranks on one host)."""

from .slices import (uniform_slice_stack, phase_a_sharded, make_mesh,
                     unstack_slices)
from .ffv1 import ParallelFFV1Encoder
from .ffv2 import encode_front_q_sharded
