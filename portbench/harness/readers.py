"""What the metric readers (``metrics/<name>.py``) share. A reader returns
None where its cell has nothing for it to read."""
from harness.peaks import PEAK_OPS_PER_S

FLASH_FWD = ("flash_fwd",)
FLASH_BWD = ("flash_bwd",)
DECODE_ATTENTION = ("decode_attention_kernel", "multi_query_kernel")


def rate(reading, kind: str, key: str):
    """Work of the whole measured window over its seconds."""
    out = reading.outcome
    if reading.kind != kind or out.window_s <= 0:
        return None
    return out.work.get(key, 0.0) / out.window_s


def traced(reading, kind: str):
    """The traced slice and its work, or None."""
    out = reading.outcome
    if reading.kind != kind or out.trace is None or not out.trace.device_ops:
        return None
    return out.trace, out.trace_work


def per_unit(reading, kind: str, key: str):
    """Device operations of the traced slice per unit of ``key``."""
    got = traced(reading, kind)
    if got is None or not got[1].get(key):
        return None
    return got[0].kernel_count() / got[1][key]


def mfu(reading, kind: str):
    """Model FLOPs of the traced units over the slice's seconds and the
    chips' bf16 peak, in %."""
    got = traced(reading, kind)
    if got is None or not got[1].get("flops"):
        return None
    trace, work = got
    return 100.0 * work["flops"] / (trace.window_s * reading.cell.chips
                                     * PEAK_OPS_PER_S["bfloat16"])


def idle_share(reading, kind: str):
    got = traced(reading, kind)
    if got is None or got[0].window_s <= 0:
        return None
    return 100.0 * (1.0 - got[0].busy_s / got[0].window_s)


def roofline(reading, kind: str, least_key: str, names):
    """The least seconds of the traced units' calls over the device seconds
    of the kernels that ran them, in %; None where those kernels did not run."""
    got = traced(reading, kind)
    if got is None or not got[1].get(least_key):
        return None
    spent = got[0].kernel_seconds(*names)
    return None if spent <= 0 else 100.0 * got[1][least_key] / spent
