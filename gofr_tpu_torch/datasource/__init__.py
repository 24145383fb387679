"""Datasource drivers: each wraps a client + logs + metrics + traces
(gofr `pkg/gofr/datasource/` pattern: observability is free at the driver layer).

The port's own copy of gofr_tpu/datasource/__init__.py.
"""


class DatasourceError(Exception):
    """Wraps an underlying driver error with a 500 status
    (gofr `datasource/errors.go`)."""

    status_code = 500

    def __init__(self, err: BaseException | str, message: str = ""):
        self.err = err
        self.message = message or str(err)
        super().__init__(self.message)
