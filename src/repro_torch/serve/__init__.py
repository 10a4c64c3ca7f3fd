"""Serving a fitted DPMM: ``DPMMEngine`` (``serve/dpmm.py``)."""
from repro_torch.serve.dpmm import (DPMMEngine, InvalidQueryError,
                                    PublishRejected, ServeConfig,
                                    ServeResult)

__all__ = ["DPMMEngine", "InvalidQueryError", "PublishRejected",
           "ServeConfig", "ServeResult"]
