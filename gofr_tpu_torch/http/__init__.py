"""HTTP-facing pieces of the port (counterpart of gofr_tpu.http): for now
only the typed errors the engine raises."""
