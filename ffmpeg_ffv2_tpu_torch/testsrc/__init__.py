"""Copy of ``ffmpeg_ffv2_tpu/testsrc/``: the FATE synthetic sources
(vsynth1/vsynth3 from videogen.c, vsynth2 from rotozoom.c), numpy
only."""

from .videogen import vsynth1_frames, vsynth3_frames, rgb24_to_yuv420p
from .rotozoom import rotozoom_frames
