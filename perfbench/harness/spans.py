"""The program's own layer spans, read after a traced run.

`moegan_tpu_torch.utils.profiling` records a span at each layer boundary
while a torch profiler session runs: the benchmark's traced stretches (the
CUDA-API stretch and the profiled one) turn it on. Each span it timed on
the card holds its device time, from timing events on the stream it ran
on. The recorder keeps every span of the process, so a per-step reading
divides by the number of root spans it holds (`moegan.step` or
`moegan.sample`), not by the profiled stretch's units.

Every reader returns None where the recorder holds no such span timed on
the card: a program without the recorder, a run without a card.
"""

from __future__ import annotations

import re

from perfbench.counts import kernels
from perfbench.reference.model import channels

STEP = "moegan.step"
SAMPLE = "moegan.sample"
UPSAMPLE = re.compile(r"^moegan\.g\.r(\d+)\.upsample$")


def recorded() -> dict | None:
    """{span name: {"count", "host_ms", "device_ms", "self_device_ms"}} of the
    program's recorder after a synchronisation; None without a card or a
    recorder."""
    import torch

    if not torch.cuda.is_available():
        return None
    try:
        from moegan_tpu_torch.utils import profiling
    except ImportError:
        return None
    summary = getattr(profiling, "summary", None)
    if summary is None:
        return None
    torch.cuda.synchronize()
    return summary()["spans"]


def device_ms_per_root(spans: dict | None, root: str, names) -> float | None:
    """Device ms of the spans `names` (summed) per `root` span; None where the
    recorder timed none of them or holds no root."""
    if not spans or not spans.get(root, {}).get("count"):
        return None
    timed = [spans[n]["device_ms"] for n in names
             if n in spans and spans[n]["device_ms"] is not None]
    if not timed:
        return None
    return sum(timed) / spans[root]["count"]


def upsample_bytes(batch: int, r: int, ch: dict) -> float:
    """Least bytes of the x2 bilinear upsample into resolution r: its bf16
    input [batch, r/2, r/2, channels[r/2]] read once and its bf16 output,
    four times as large, written once."""
    return 10.0 * batch * (r // 2) ** 2 * ch[r // 2]


def upsample_roofline(spans: dict | None, g: dict, batch: int) -> float | None:
    """Share of its roofline, %: the least time for the work of every upsample
    span recorded (each occurrence its own) over those spans' device time."""
    if not spans:
        return None
    ch = channels(g)
    need_s = busy_ms = 0.0
    for name, s in spans.items():
        m = UPSAMPLE.match(name)
        if m is None or s["device_ms"] is None:
            continue
        need_s += s["count"] * upsample_bytes(batch, int(m.group(1)), ch) / kernels.PEAK_BYTES
        busy_ms += s["device_ms"]
    if busy_ms <= 0.0:
        return None
    return 100.0 * need_s / (busy_ms * 1e-3)
