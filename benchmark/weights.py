"""The field's weights, made by the benchmark from the seed on the run's
device, in a few large draws, under the state-dict names of the reference
checkpoint (which the port's ``NeuconWField`` loads strictly).

The distributions are the port's initialisation (``tools/convert.
init_field``): an N(0, 1) appearance table; the SDF net's geometric init
(N(0, 2 / d_out) weights with layer 0's and the skip's encoding columns
zeroed, zero biases, the last layer sqrt(pi / d_in) + N(0, 1e-8) and bias
-0.5, so sdf(x) ~ |x| - 0.5); torch's default U(+-1 / sqrt(d_in)) for every
other weight and bias; weight-normed layers with g = |v| row by row; the
variance S_CONFIG.init_val. The numbers are the benchmark's own: both the
program and the reference are handed this dict."""

from __future__ import annotations

import math

import torch

from .counts.field import NERF_D, NERF_PE, NERF_SKIP, NERF_VIEW_PE, NERF_W, pe_dim, \
    sdf_products


def shapes(cfg: dict) -> tuple:
    """([(name, (d_out, d_in), kind)], ...) of every linear, and the
    appearance table's and the variance's shapes. kind: 'sdf' (geometric
    init, weight-normed), 'wn' (weight-normed, uniform), 'plain'."""
    n = cfg["NEUCONW"]
    sdf, color, n_a = n["SDF_CONFIG"], n["COLOR_CONFIG"], n["N_A"]
    lins = [(f"neuconw.sdf_net.lin{l}", (d_out, d_in), "sdf")
            for l, (d_in, d_out) in enumerate(sdf_products(sdf))]
    view = pe_dim(3, color["multires_view"])
    h, f = color["head_channels"], color["d_feature"]
    wn = "wn" if color["weight_norm"] else "plain"
    if n["ENCODE_A"]:
        d0 = color["d_in"] + h - 3
        lins.append(("neuconw.color_net.xyz_encoding_final", (f, f), "plain"))
        for s in range(color["static_head_layers"]):
            lins.append((f"neuconw.color_net.static_encoding.static_linear_{s}",
                         (h, f + n_a + view if s == 0 else h), "plain"))
    else:
        d0 = color["d_in"] + f + view - 3
    dims = [d0] + [color["d_hidden"]] * color["n_layers"] + [color["d_out"]]
    lins += [(f"neuconw.color_net.lin{l}", (dims[l + 1], dims[l]), wn)
             for l in range(len(dims) - 1)]
    d_pe, v_pe, w = pe_dim(4, NERF_PE), pe_dim(3, NERF_VIEW_PE), NERF_W
    lins += [(f"nerf.pts_linears.{i}", (w, d_pe if i == 0 else w + d_pe if i - 1 == NERF_SKIP
                                        else w), "plain") for i in range(NERF_D)]
    lins += [("nerf.alpha_linear", (1, w), "plain"), ("nerf.feature_linear", (w, w), "plain")]
    if n["ENCODE_A_BG"]:
        lins += [(f"nerf.apperence_encoding.static_linear_{s}",
                  (w // 2, w + v_pe + n_a if s == 0 else w // 2), "plain")
                 for s in range(NERF_D // 2)]
    else:
        lins.append(("nerf.views_linears.0", (w // 2, w + v_pe), "plain"))
    lins.append(("nerf.rgb_linear", (3, w // 2), "plain"))
    return lins, (n["N_VOCAB"], n_a)


def make_weights(cfg: dict, gen: torch.Generator) -> dict:
    """The state dict (float32, on the generator's device) from one normal
    and one uniform draw."""
    lins, table = shapes(cfg)
    sdf = cfg["NEUCONW"]["SDF_CONFIG"]
    dev = gen.device
    n_normal = table[0] * table[1] + sum(o * i for _, (o, i), k in lins if k == "sdf")
    n_uniform = sum(o * i + o for _, (o, i), k in lins if k != "sdf")
    normal = torch.randn(n_normal, generator=gen, device=dev)
    uniform = torch.rand(n_uniform, generator=gen, device=dev) * 2.0 - 1.0
    cur = {"n": 0, "u": 0}

    def take(buf, key, shape):
        k = math.prod(shape)
        out = buf[cur[key]:cur[key] + k].reshape(shape)
        cur[key] += k
        return out

    sd = {"embedding_a.weight": take(normal, "n", table).clone()}
    d_pe = pe_dim(sdf["d_in"], sdf["multires"])
    n_sdf = sum(1 for _, _, k in lins if k == "sdf")
    for name, (d_out, d_in), kind in lins:
        if kind == "sdf":
            l = int(name.rsplit("lin", 1)[1])
            z = take(normal, "n", (d_out, d_in))
            if l == n_sdf - 1:
                sign = -1.0 if sdf["inside_outside"] else 1.0
                w = sign * math.sqrt(math.pi) / math.sqrt(d_in) + 1e-4 * z
                b = torch.full((d_out,), sdf["bias"] if sdf["inside_outside"] else -sdf["bias"],
                               device=dev)
            else:
                w = z * (math.sqrt(2) / math.sqrt(d_out))
                if sdf["multires"] > 0 and l == 0:
                    w[:, 3:] = 0.0
                elif sdf["multires"] > 0 and l in tuple(sdf["skip_in"]):
                    w[:, -(d_pe - 3):] = 0.0
                b = torch.zeros(d_out, device=dev)
        else:
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
        float(cfg["NEUCONW"]["S_CONFIG"]["init_val"]), device=dev)
    return sd
