"""Host time a job spends in the LSTM step's polynomial activations (σ3 on f, i
and o, tanh3 on c̃ and on c_t): the union of the outermost ``fhe.lstm.act`` spans,
in ms."""

from fhebench import spans, tracing


def read(t: tracing.Trace):
    return spans.ms_per_job(t, ("fhe.lstm.act",))
