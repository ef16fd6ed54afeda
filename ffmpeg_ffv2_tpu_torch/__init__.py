"""ffmpeg_ffv2_tpu_torch -- the FFV1 device encoder and the FFV2 codec on
PyTorch and CUDA.

A port of the JAX/TPU package ``ffmpeg_ffv2_tpu`` to PyTorch on NVIDIA
Hopper GPUs.  It imports neither jax nor ``ffmpeg_ffv2_tpu``: the host
side it needs (params, headers, the range encoder, CRC, the native C++
codec that serves as its oracle) is copied under mirror paths
(``core/``, ``coder/``, ``ffv1/``, ``native/``).

``ffv1.device_coder.DeviceFFV1Encoder`` encodes frames through
hand-written CUDA kernels (``csrc/*.cu``, built on first use by
``_build``): with the range coder K1 place, K2 adapt, K3 expand and K4
rac_render; with the Golomb-Rice coder K1 place, K5 vlc and the run-index
ladder; ``encode_batch`` runs B key frames through K1-K4 as B x S slices.
``convert.device`` holds the pixel-format conversions on tensors (plain
PyTorch, held against the numpy models of ``convert.yuv_rgb``).
``ops.sort_rows`` is the bitonic row sort (K8, K9), and ``tools/`` holds
the counterparts of the repository's Pallas tools (K10-K17) and of
``tools/bench_batch_scale.py``.  ``ffv2/`` is the FFV2 transform codec:
``ffv2.native.NativeFFV2Encoder``, ``PipelinedFFV2Encoder`` and
``NativeFFV2Decoder`` run its device front and back (``ffv2.device``: the
lapped filters on K19, the float64 transforms, the PVQ quantizer on K18)
around the native Daala coder.  ``cli`` is the command line (FFV1, FFV2
and ``--mesh`` on a world of ranks), ``testsrc`` the FATE synthetic
sources, ``graft_entry`` the twin of the repository's
``__graft_entry__.py``.
"""

__version__ = "0.1.0"      # the JAX package's; FFV2's debug OSD prints it
