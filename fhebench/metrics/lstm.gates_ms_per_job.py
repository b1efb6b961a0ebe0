"""Host time a job spends in the LSTM step's gates (the eight BSGS matvecs, their
adds and the biases): the union of the outermost ``fhe.lstm.gates`` spans, in ms."""

from fhebench import spans, tracing


def read(t: tracing.Trace):
    return spans.ms_per_job(t, ("fhe.lstm.gates",))
