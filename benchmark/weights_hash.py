"""The weights of a hash-grid SDF field (``configs/neuralangelo_op.json``),
made by the benchmark from the seed on the run's device in one normal and
one uniform draw, under the field's state-dict names.

They stand for a steady state, not an initialisation (at Neuralangelo's
init, layer 0's encoding columns are zero and the table is U(+-1e-4), so
the grid would move nothing and a wrong hash, a missing level or a broken
scatter-add would pass every check):

* the table: level l's entries N(0, sigma_l), sigma_l = table_sigma x (N_0 /
  N_l)^table_falloff (``assumed``): the coarse levels move the sdf by
  O(0.1), each finer level by less, and the gradient a level adds falls as
  N_l^(1 - falloff), so |grad sdf| stays O(1) as in a trained field;
* layer 0's encoding columns at torch's default scale, U(+-1 / sqrt(d_in));
  its x columns and the other layers the geometric init (N(0, 2 / d_out)
  weights, zero biases; the last layer sqrt(pi / d_in) + N(0, 1e-8), bias
  -bias), weight-normed with g = |v| row by row;
* the colour head, the background, the appearance table and the variance
  as ``weights.make_weights`` draws them."""

from __future__ import annotations

import copy
import math

import torch

from .reference import hashgrid as H
from .weights import shapes

# an SDF section with one product, for ``weights.shapes``' other layers
_STUB_SDF = {"d_in": 3, "multires": 0, "d_hidden": 1, "n_layers": 0, "d_out": 1, "skip_in": []}


def sdf_shapes(sdf: dict) -> list:
    """(name, (d_out, d_in)) of the hash net's layers."""
    width = int(sdf["d_in"]) + int(sdf["levels"]) * int(sdf["features"])
    dims = [width] + [int(sdf["d_hidden"])] * int(sdf["n_layers"]) + [int(sdf["d_out"])]
    return [(f"{H.SDF}lin{l}", (dims[l + 1], dims[l])) for l in range(len(dims) - 1)]


def make_weights(cfg: dict, gen: torch.Generator) -> dict:
    n = cfg["NEUCONW"]
    sdf = n["SDF_CONFIG"]
    stub = copy.deepcopy(cfg)
    stub["NEUCONW"]["SDF_CONFIG"] = dict(_STUB_SDF)
    lins, vocab = shapes(stub)
    lins = [x for x in lins if x[2] != "sdf"]
    sdf_lins = sdf_shapes(sdf)
    feats = int(sdf["features"])
    entries = H.n_entries(sdf)
    d_in0 = sdf_lins[0][1][1]
    enc_cols = d_in0 - int(sdf["d_in"])
    dev = gen.device
    n_normal = vocab[0] * vocab[1] + entries * feats + sum(o * i for _, (o, i) in sdf_lins)
    n_uniform = sdf_lins[0][1][0] * enc_cols + sum(o * i + o for _, (o, i), _ in lins)
    normal = torch.randn(n_normal, generator=gen, device=dev)
    uniform = torch.rand(n_uniform, generator=gen, device=dev) * 2.0 - 1.0
    cur = {"n": 0, "u": 0}

    def take(buf, key, shape):
        k = math.prod(shape)
        out = buf[cur[key]:cur[key] + k].reshape(shape)
        cur[key] += k
        return out

    sd = {"embedding_a.weight": take(normal, "n", vocab).clone()}
    table = take(normal, "n", (entries, feats)).clone()
    sigma = float(cfg["assumed"]["table_sigma"])
    falloff = float(cfg["assumed"]["table_falloff"])
    res = H.resolutions(sdf)
    for (n_l, off, dense), n_next in zip(H.layout(sdf), [x[1] for x in H.layout(sdf)[1:]]
                                         + [entries]):
        table[off:n_next] *= sigma * (res[0] / n_l) ** falloff
    sd[f"{H.SDF}table"] = table
    last = len(sdf_lins) - 1
    for l, (name, (d_out, d_in)) in enumerate(sdf_lins):
        z = take(normal, "n", (d_out, d_in))
        if l == last:
            w = math.sqrt(math.pi) / math.sqrt(d_in) + 1e-4 * z
            b = torch.full((d_out,), -float(sdf["bias"]), device=dev)
        else:
            w = z * (math.sqrt(2) / math.sqrt(d_out))
            if l == 0:
                w[:, int(sdf["d_in"]):] = take(uniform, "u", (d_out, enc_cols)) / math.sqrt(d_in)
            b = torch.zeros(d_out, device=dev)
        sd[f"{name}.weight_v"] = w.clone()
        sd[f"{name}.weight_g"] = torch.linalg.vector_norm(w, dim=1, keepdim=True)
        sd[f"{name}.bias"] = b.clone()
    for name, (d_out, d_in), kind in lins:
        bound = 1.0 / math.sqrt(d_in)
        w = take(uniform, "u", (d_out, d_in)) * bound
        b = take(uniform, "u", (d_out,)) * bound
        if kind == "plain":
            sd[f"{name}.weight"] = w.clone()
        else:
            sd[f"{name}.weight_v"] = w.clone()
            sd[f"{name}.weight_g"] = torch.linalg.vector_norm(w, dim=1, keepdim=True)
        sd[f"{name}.bias"] = b.clone()
    sd["neuconw.deviation_network.variance"] = torch.tensor(
        float(n["S_CONFIG"]["init_val"]), device=dev)
    return sd
