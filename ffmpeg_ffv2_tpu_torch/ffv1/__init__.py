"""FFV1 device encoder (PyTorch/CUDA port of ffmpeg_ffv2_tpu.ffv1), and the
Python codec's exports of ``ffmpeg_ffv2_tpu/ffv1/__init__.py``."""
from .params import FFV1Config, FFV1Params, CODER_GOLOMB, CODER_RANGE_DEFAULT, CODER_RANGE_CUSTOM
from .encoder import FFV1Encoder
from .decoder import FFV1Decoder
