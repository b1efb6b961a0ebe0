"""Key-switches per job inside the training period's rotate-and-sum chains: the
outermost ``fhe.keyswitch`` spans that lie inside an outermost
``fhe.logreg.rotsum`` span, over the jobs (one standard rotation each)."""

from fhebench import spans, tracing


def read(t: tracing.Trace):
    chains = spans.outermost(t, ("fhe.logreg.rotsum",))
    if not chains or not t.jobs:
        return None
    switches = spans.outermost(t, spans.KEYSWITCH)
    return sum(1 for a, b in switches if any(c0 <= a and b <= c1 for c0, c1 in chains)) / t.jobs
