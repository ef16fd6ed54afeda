"""Host coders copied from ffmpeg_ffv2_tpu.coder (range encoder, symbols,
the Golomb-Rice run ladder and VLC state)."""
