"""Standard-library shims: the TOML loader (the port's copy of
``distributed_inference_server_tpu/utils/compat.py``'s ``load_toml``)."""

from __future__ import annotations


def load_toml(path: str) -> dict:
    """Parse a TOML file with the standard library's ``tomllib``."""
    import tomllib

    with open(path, "rb") as f:
        return tomllib.load(f)
