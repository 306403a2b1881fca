"""How long a dispatch's results wait before they are handed on: the mean
over the window's dispatches of the k-th ``rx.deliver`` span's start (the
k-th ``on_results`` call of ``run_pipelined``) less the k-th
``rx.dispatch`` span's end, paired in order."""
from ..spans import spans


def read(trace, cell):
    pairs = list(zip(spans(trace, "rx.dispatch"),
                     spans(trace, "rx.deliver")))
    if not pairs:
        return None
    return sum(d.start - s.end for s, d in pairs) * 1e-3 / len(pairs)
