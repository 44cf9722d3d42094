"""Party-tagged logging (parity: reference ``fed/utils.py:77-111``,
``fed/_private/constants.py:34-36``)."""

from __future__ import annotations

import logging
import threading
from typing import Optional

RAYFED_LOG_FORMAT = (
    "%(asctime)s %(levelname)s %(filename)s:%(lineno)s"
    " [%(party)s] -- %(message)s"
)

_tls = threading.local()


def set_thread_party(party: Optional[str]) -> None:
    _tls.party = party


class PartyRecordFilter(logging.Filter):
    """Injects the current party into every record.

    The reference pins one party per process; we additionally consult a
    thread-local so multi-party-in-one-process simulation logs correctly.
    """

    def __init__(self, party: Optional[str] = None) -> None:
        super().__init__()
        self._party = party

    def filter(self, record: logging.LogRecord) -> bool:
        if not hasattr(record, "party"):
            record.party = getattr(_tls, "party", None) or self._party or "-"
        return True


def setup_logger(
    logging_level: str = "info",
    logging_format: str = RAYFED_LOG_FORMAT,
    date_format: Optional[str] = None,
    party: Optional[str] = None,
) -> None:
    root = logging.getLogger()
    root.setLevel(getattr(logging, str(logging_level).upper(), logging.INFO))
    formatter = logging.Formatter(logging_format, datefmt=date_format)
    filt = PartyRecordFilter(party)
    has_handler = False
    for handler in root.handlers:
        if getattr(handler, "_rayfed_handler", False):
            has_handler = True
            handler.setFormatter(formatter)
    if not has_handler:
        handler = logging.StreamHandler()
        handler._rayfed_handler = True  # type: ignore[attr-defined]
        handler.setFormatter(formatter)
        handler.addFilter(filt)
        root.addHandler(handler)
    else:
        for handler in root.handlers:
            if getattr(handler, "_rayfed_handler", False):
                for f in list(handler.filters):
                    handler.removeFilter(f)
                handler.addFilter(filt)
