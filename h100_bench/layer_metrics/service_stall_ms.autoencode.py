"""Device-idle milliseconds a request that fall inside the service's
``autoencode`` span (``pdae.service.autoencode``: the input's preparation,
the solver loops, the output's checks and copy), over the traced requests.
The card's idle time outside those spans is the caller's."""

from h100_bench.spans import idle_seconds, window_spans


def read(record):
    spans = window_spans(record, "pdae.service.autoencode")
    if spans is None:
        return None
    return 1e3 * idle_seconds(record, spans, "pdae.service.autoencode") / record["units"]
