"""The share of the candidate rows the program decoded that were detected:
100 x its ``rows_detected`` counter over its ``rows_decoded`` counter
(rows through ``_decode_window``: every candidate row of a dispatch whose
gate opened), both counted while the window was traced."""
from ..spans import counter


def read(trace, cell):
    decoded, detected = counter("rows_decoded"), counter("rows_detected")
    if not decoded or detected is None:
        return None
    return 100.0 * detected / decoded
