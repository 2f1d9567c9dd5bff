"""Small host-side helpers (port of ``simseg_tpu/utils/misc.py``).

Parity: reference ``simseg/utils/misc.py`` — AverageMeter (:377-400),
split_list_evenly, to_list and the download helpers (:416-436; stdlib
``urllib``, as in JAX).
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence


class AverageMeter:
    """Tracks current value, running sum, count and mean
    (parity: misc.py:377-400)."""

    def __init__(self, name: str = "", fmt: str = ":f") -> None:
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1) -> None:
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)

    def __str__(self) -> str:
        return f"{self.name} {self.val:{self.fmt[1:]}} ({self.avg:{self.fmt[1:]}})"


def split_list_evenly(lst: Sequence[Any], n: int) -> List[List[Any]]:
    """Split into n chunks whose sizes differ by at most one, the longer
    ones first."""
    q, r = divmod(len(lst), n)
    out, start = [], 0
    for i in range(n):
        size = q + (1 if i < r else 0)
        out.append(list(lst[start:start + size]))
        start += size
    return out


def to_list(x: Any) -> list:
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


def download(url: str, timeout: int = 20, retry: int = 3) -> bytes:
    """The body of ``url``, tried up to ``retry`` times: a response whose
    status is not 2xx, a connection error or a timeout counts as a failed
    attempt; raises ``RuntimeError`` after the last."""
    import urllib.error
    import urllib.request

    last_err: Optional[Exception] = None
    for _ in range(max(retry, 1)):
        try:
            with urllib.request.urlopen(url, timeout=timeout) as rsp:
                # file:// responses carry status None: treated as OK
                status = getattr(rsp, "status", None) or 200
                if 200 <= status < 300:
                    return rsp.read()
                last_err = RuntimeError(f"HTTP {status}")
        except (urllib.error.URLError, OSError) as e:  # timeouts included
            last_err = e
    raise RuntimeError(f"download {url} failed") from last_err


def download_to_local_file(url: str, local_path: str, timeout: int = 20,
                           retry: int = 3) -> None:
    """``download(url)`` written to ``local_path``."""
    content = download(url, timeout=timeout, retry=retry)
    with open(local_path, "wb") as f:
        f.write(content)
