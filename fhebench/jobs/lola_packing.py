"""LoLa-MNIST's slot layout and its layers as BSGS diagonals (NumPy only).

Slots S = N/2.  The client sends the image split into the convolution's stride
planes: plane (a, b) holds the pixels (s·r + a, s·c + b), w = ⌈image/s⌉ on a
side, and the s² planes are copied once for each of the convolution's maps.
Output (m, r, c) of the convolution lies at slot m·s²w² + w·r + c; pixel
(s·r + dy, s·c + dx) of copy m lies d = (s·(dy mod s) + dx mod s)·w² +
w·⌊dy/s⌋ + ⌊dx/s⌋ slots past it, the same d for every map and position, so the
convolution is a matvec of kernel² diagonals.  Taps that fall on the padding
read nothing: their coefficient is 0.

A dense layer (rows × cols) on an input that repeats with period n (n = S, or
a smaller period) is the hybrid diagonal method: R = rows padded to a power of
two, R diagonals diag_d[i] = W[i mod R, the column at slot (i + d) mod n], then
log2(n/R) rotate-and-adds by R, 2R, …, n/2.  Row o of the answer then lies at
every slot i ≡ o (mod R), so the next layer's input repeats with period R.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Layer:
    name: str
    diags: dict  # d → diagonal over the S slots
    n1: int
    folds: list  # rotate-and-add steps after the product
    bias: np.ndarray  # over the S slots, in the layer's output layout


def geometry(cfg: dict) -> dict:
    net = cfg["network"]
    img, s, k = net["image"], net["conv"]["stride"], net["conv"]["kernel"]
    w = -(-img // s)
    out = (img + net["pad"] - k) // s + 1
    return dict(image=img, stride=s, kernel=k, side=w, out=out, maps=net["conv"]["maps"],
                copy=s * s * w * w, slots=cfg["n"] // 2)


def image_slots(cfg: dict, image: np.ndarray) -> np.ndarray:
    """The client's slots for one image: its stride planes, once for each map."""
    g = geometry(cfg)
    s, w = g["stride"], g["side"]
    if g["maps"] * g["copy"] > g["slots"]:
        raise ValueError("the image's copies do not fit the slots")
    y, x = np.meshgrid(np.arange(g["image"]), np.arange(g["image"]), indexing="ij")
    pos = ((y % s) * s + x % s) * w * w + w * (y // s) + x // s
    z = np.zeros(g["slots"])
    for m in range(g["maps"]):
        z[m * g["copy"] + pos] = image
    return z


def conv_out_slots(cfg: dict) -> np.ndarray:
    """The slot of each convolution output, in (map, row, column) order."""
    g = geometry(cfg)
    m, r, c = np.meshgrid(np.arange(g["maps"]), np.arange(g["out"]), np.arange(g["out"]), indexing="ij")
    return (m * g["copy"] + g["side"] * r + c).ravel()


def conv_diagonals(cfg: dict, kernel: np.ndarray) -> dict:
    g = geometry(cfg)
    s, w, out = g["stride"], g["side"], g["out"]
    r, c = np.meshgrid(np.arange(out), np.arange(out), indexing="ij")
    diags = {}
    for dy in range(g["kernel"]):
        for dx in range(g["kernel"]):
            d = ((dy % s) * s + dx % s) * w * w + w * (dy // s) + dx // s
            inside = (s * r + dy < g["image"]) & (s * c + dx < g["image"])
            u = np.zeros(g["slots"])
            for m in range(g["maps"]):
                u[(m * g["copy"] + w * r + c)[inside]] = kernel[m, dy, dx]
            diags[d] = u
    return diags


def dense_diagonals(weight: np.ndarray, in_slots: np.ndarray, period: int, slots: int):
    """(diagonals, folds, R) of the hybrid method for ``weight`` on an input whose
    column k lies at slot in_slots[k] and repeats with ``period``."""
    rows, cols = weight.shape
    R = 1 << (rows - 1).bit_length()
    if period % R or slots % period:
        raise ValueError("the padded rows must divide the period, and the period the slots")
    col_at = np.full(period, -1)
    col_at[np.asarray(in_slots)] = np.arange(cols)
    i = np.arange(period)
    o = i % R
    diags = {}
    for d in range(R):
        k = col_at[(i + d) % period]
        u = np.where((k >= 0) & (o < rows), weight[np.minimum(o, rows - 1), np.maximum(k, 0)], 0.0)
        diags[d] = np.tile(u, slots // period)
    folds = [R << t for t in range((period // R).bit_length() - 1)]
    return diags, folds, R


def layers(cfg: dict, weights: dict) -> list[Layer]:
    """The network's linear layers in order, each with its bias in its output layout."""
    g = geometry(cfg)
    slots, pack = g["slots"], cfg["packing"]
    conv_bias = np.zeros(slots)
    at = conv_out_slots(cfg)
    conv_bias[at] = np.repeat(weights["conv.bias"], g["out"] * g["out"])
    out = [Layer("conv", conv_diagonals(cfg, weights["conv"]), pack["conv_n1"], [], conv_bias)]
    in_slots, period = at, slots
    for j, n1 in enumerate(pack["dense_n1"], 1):
        w, b = weights[f"dense.{j}"], weights[f"dense.{j}.bias"]
        diags, folds, R = dense_diagonals(w, in_slots, period, slots)
        bias = np.zeros(R)
        bias[: len(b)] = b
        out.append(Layer(f"dense.{j}", diags, n1, folds, np.tile(bias, slots // R)))
        in_slots, period = np.arange(w.shape[0]), R
    return out
