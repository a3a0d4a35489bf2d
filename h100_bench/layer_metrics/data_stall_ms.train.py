"""Device-idle milliseconds a step that fall inside the batch stream's
waits (``pdae.loader.next``): the time the card waited for data, over the
traced steps."""

from h100_bench.spans import idle_seconds, window_spans


def read(record):
    spans = window_spans(record, "pdae.train.step")
    if spans is None:
        return None
    return 1e3 * idle_seconds(record, spans, "pdae.loader.next") / record["units"]
