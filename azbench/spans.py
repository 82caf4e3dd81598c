"""The program's span totals (``alphazero_tpu_torch.utils.profiling``):
``{name: (count, total_s, self_s, n)}``.

The program records its spans only while a profiler runs, and nothing but
``trace.profile`` runs one in a run of a cell, so the totals are those of
the traced stretch, the one ``idle_share`` is taken over.  A program
without the recorder gives ``{}``, and every reader then returns None."""


def totals() -> dict:
    from alphazero_tpu_torch.utils import profiling
    read = getattr(profiling, "totals", None)
    return read() if read is not None else {}
