"""Device, step programs and the serving engine (counterpart of gofr_tpu.tpu)."""
