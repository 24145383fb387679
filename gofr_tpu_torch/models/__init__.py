"""Model families of the port (counterpart of gofr_tpu.models)."""
