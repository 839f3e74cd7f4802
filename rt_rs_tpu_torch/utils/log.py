"""Logging init — parity with the reference's logger setup
(``simple_logger`` at Info on native, ``wasm_logger`` on web;
``src/lib/mod.rs:210-221``)."""

from __future__ import annotations

import logging


def init_logging(level: int = logging.INFO) -> None:
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(levelname)s [%(name)s] %(message)s",
    )


logger = logging.getLogger("rt_rs_tpu_torch")
