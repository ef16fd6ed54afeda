"""Pixel-format conversions: ``yuv_rgb`` (the byte-exact numpy models, a
copy of the JAX package's, with their tables) and ``device`` (the same
conversions on tensors on the card, the counterpart of
``ffmpeg_ffv2_tpu/convert/tpu.py``)."""
