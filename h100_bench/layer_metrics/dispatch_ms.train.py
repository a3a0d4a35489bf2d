"""Host milliseconds a step inside the step's dispatch (``pdae.train.step``:
the graph dispatcher's input copy, re-seed, replay launch and output copy),
over the traced steps. Where the host runs ahead of the card, this is the
time its launches wait for room in the card's queue."""

from h100_bench.spans import host_seconds, window_spans


def read(record):
    spans = window_spans(record, "pdae.train.step")
    if spans is None:
        return None
    return 1e3 * host_seconds(spans, "pdae.train.step") / record["units"]
