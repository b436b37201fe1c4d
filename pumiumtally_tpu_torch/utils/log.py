"""Structured logging for the port.

Counterpart of ``pumiumtally_tpu/utils/log.py``: the reference's
``[INFO]``/``[ERROR]``/``[TIME]`` tags on the stdlib logging machinery,
with levels, an env-controlled threshold (``PUMI_TPU_LOG=debug``) and an
optional JSON-lines mode (``PUMI_TPU_LOG_JSON=1``). The environment
variables are the JAX package's, so one setting steers both. The logger
is ``pumiumtally_tpu_torch``, apart from the JAX package's.
"""
from __future__ import annotations

import json
import logging
import os
import sys
import time

_LOGGER_NAME = "pumiumtally_tpu_torch"
_TAGS = {
    logging.DEBUG: "[DEBUG]",
    logging.INFO: "[INFO]",
    logging.WARNING: "[WARN]",
    logging.ERROR: "[ERROR]",
}


class _TagFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        if os.environ.get("PUMI_TPU_LOG_JSON") == "1":
            payload = {
                "ts": round(time.time(), 3),
                "level": record.levelname.lower(),
                "msg": record.getMessage(),
            }
            extra = getattr(record, "fields", None)
            if extra:
                payload.update(extra)
            return json.dumps(payload)
        tag = getattr(record, "tag", None) or _TAGS.get(
            record.levelno, f"[{record.levelname}]"
        )
        fields = getattr(record, "fields", None)
        rendered = getattr(record, "fields_in_message", ())
        if fields and rendered:
            # Drop only the fields the message text already holds.
            fields = {k: v for k, v in fields.items() if k not in rendered}
        suffix = (
            " " + " ".join(f"{k}={v}" for k, v in fields.items())
            if fields
            else ""
        )
        return f"{tag} {record.getMessage()}{suffix}"


class _StderrHandler(logging.StreamHandler):
    """Resolves sys.stderr at emit time, so stream redirection (pytest's
    capsys, a host's log capture) works."""

    def __init__(self):
        logging.Handler.__init__(self)

    @property
    def stream(self):
        return sys.stderr


def get_logger() -> logging.Logger:
    logger = logging.getLogger(_LOGGER_NAME)
    if not logger.handlers:
        handler = _StderrHandler()
        handler.setFormatter(_TagFormatter())
        logger.addHandler(handler)
        logger.propagate = False
        level = os.environ.get("PUMI_TPU_LOG", "info").upper()
        logger.setLevel(getattr(logging, level, logging.INFO))
    return logger


def log_info(msg: str, **fields) -> None:
    get_logger().info(msg, extra={"fields": fields} if fields else None)


def log_warn(msg: str, **fields) -> None:
    get_logger().warning(msg, extra={"fields": fields} if fields else None)


def log_error(msg: str, **fields) -> None:
    get_logger().error(msg, extra={"fields": fields} if fields else None)


def metrics_path() -> str | None:
    """Path of the JSONL metrics sink, from ``PUMI_TPU_METRICS=jsonl:/path``
    (the flight recorder's emission channel). None when unset or when the
    spec names another scheme: metric emission never takes a run down."""
    spec = os.environ.get("PUMI_TPU_METRICS", "")
    if spec.startswith("jsonl:"):
        return spec[len("jsonl:"):] or None
    return None


_metric_sink_warned: set = set()


def emit_metric(fields: dict, path: str | None = None) -> None:
    """Emit one metrics record: a debug-level record through the logger
    (rendered as JSON under ``PUMI_TPU_LOG_JSON=1``), plus one JSON line
    appended to ``path`` or, without one, to the
    ``PUMI_TPU_METRICS=jsonl:<path>`` sink when one is set: ts, level and
    msg, then the record's flat fields. An unwritable sink logs one
    warning per path and drops the records."""
    kind = str(fields.get("kind", "metric"))
    get_logger().debug(
        kind, extra={"fields": fields, "tag": "[METRIC]"}
    )
    path = path or metrics_path()
    if not path:
        return
    payload = {
        "ts": round(time.time(), 3),
        "level": "metric",
        "msg": kind,
        **fields,
    }
    try:
        with open(path, "a") as f:
            f.write(json.dumps(payload, default=str) + "\n")
    except OSError as e:
        if path not in _metric_sink_warned:
            _metric_sink_warned.add(path)
            get_logger().warning(
                f"metrics sink {path!r} unwritable ({e}); dropping "
                "metric records for this path"
            )


def log_time(phase: str, seconds: float, **fields) -> None:
    """A ``[TIME]``-tagged record. The phase and seconds fields feed the
    JSON mode; the text mode has them in the message."""
    get_logger().info(
        f"{phase}: {seconds:.6f} s",
        extra={
            "fields": {
                "phase": phase, "seconds": round(seconds, 6), **fields
            },
            "fields_in_message": ("phase", "seconds"),
            "tag": "[TIME]",
        },
    )
