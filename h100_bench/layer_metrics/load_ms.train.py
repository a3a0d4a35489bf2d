"""Host milliseconds a step inside the training loop's batch stream
(``pdae.loader.next``: the host loader's fetch and collate, the pin and the
launch of the H2D copy), over the traced steps."""

from h100_bench.spans import host_seconds, window_spans


def read(record):
    spans = window_spans(record, "pdae.train.step")
    if spans is None:
        return None
    return 1e3 * host_seconds(spans, "pdae.loader.next") / record["units"]
