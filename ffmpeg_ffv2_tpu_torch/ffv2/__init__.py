"""FFV2, the fork's Daala-style transform codec: copies of the JAX
package's host modules (``codec``, ``dsp``, ``entropy``, ``osd``, ``pvq``,
``tables``), the device front and back on PyTorch (``device``, the
counterpart of ``ffmpeg_ffv2_tpu/ffv2/tpu.py``) and the native sessions
(``native``).  Exports as ``ffmpeg_ffv2_tpu/ffv2/__init__.py``."""

from .codec import FFV2Encoder, FFV2Decoder, FFV2Config
from .entropy import DaalaEncoder, DaalaDecoder, DaalaCDF
