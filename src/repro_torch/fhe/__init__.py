"""The CKKS and BGV FHE schemes in PyTorch, with CUDA kernels on the hot path.

Residues are int32 tensors (every prime is < 2^31); the plain versions of the
kernels compute in int64 and the kernels read the buffers as uint32_t.

Public API: ``FheContext`` and ``ExecPolicy`` (``repro_torch.fhe.context``;
params with ``plain_modulus`` set make a BGV context), and the modules
``linear`` (BSGS planning), ``polyeval`` (Chebyshev evaluation),
``bootstrap`` (``build_context``), ``lstm`` (one LSTM step's plan), ``logreg``
(a period of logistic-regression training), ``resnet`` (a ResNet-20 basic
block's plan) and ``bgv`` (its ciphertext types), exported lazily so that ``repro_torch.fhe.params`` and friends stay
cheap.
"""

import importlib

_CONTEXT_EXPORTS = ("FheContext", "ExecPolicy")
_LAZY_MODULES = ("linear", "polyeval", "bootstrap", "bgv", "lstm", "logreg", "resnet")


def __getattr__(name):
    if name in _CONTEXT_EXPORTS:
        from . import context

        return getattr(context, name)
    if name in _LAZY_MODULES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_CONTEXT_EXPORTS) | set(_LAZY_MODULES))
