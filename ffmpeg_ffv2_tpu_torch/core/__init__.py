"""Host helpers copied from ffmpeg_ffv2_tpu.core (CRC, pixel formats)."""
