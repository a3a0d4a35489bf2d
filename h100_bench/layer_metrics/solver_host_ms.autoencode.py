"""Host milliseconds per ShiftUNet evaluation inside the solver loops'
steps (``pdae.solver.step``: one evaluation's launches and its update),
over the traced requests. Where the host runs ahead of the card, this is
the time its launches wait for room in the card's queue."""

from h100_bench.spans import host_seconds, named, window_spans


def read(record):
    spans = window_spans(record, "pdae.service.autoencode")
    if spans is None:
        return None
    evaluations = record["units"] * record["counts"]["evaluations"]
    found = len(named(spans, "pdae.solver.step"))
    if found != evaluations:
        raise RuntimeError(f"{found} solver step spans for {evaluations} evaluations")
    return 1e3 * host_seconds(spans, "pdae.solver.step") / evaluations
