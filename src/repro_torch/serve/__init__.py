"""Serving: the DPMM engine (``serve/dpmm.py``) and the LM zoo's
generator (``serve/engine.py``)."""
from repro_torch.serve.dpmm import (DPMMEngine, InvalidQueryError,
                                    PublishRejected, ServeConfig,
                                    ServeResult)
from repro_torch.serve.engine import Generator, make_serve_step, serve_step

__all__ = ["DPMMEngine", "Generator", "InvalidQueryError", "PublishRejected",
           "ServeConfig", "ServeResult", "make_serve_step", "serve_step"]
