"""The cell's weights, made by the benchmark from ``--seed`` on the device,
in the type they are served in and in the tree the program takes.

Every scaled-normal leaf of one dtype is a view of one flat buffer filled
by a few large ``normal_`` calls from one ``torch.Generator`` on the
device, then scaled by 1/sqrt(fan_in) in place; the constant leaves
(norms, the Mamba block's dt bias, A_log and D) are fills.  The program
and the reference read the same tensors."""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

#: elements a ``normal_`` call fills (well under 2**31)
CHUNK = 1 << 30

_DT = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _leaves_moe_attention(m: Dict) -> List[Tuple]:
    """(path, shape, dtype, init, fan_in) of deepseek-style models: a
    dense first layer, then MoE layers, MHA/GQA attention."""
    d, h, kv, hd, v = (m["d_model"], m["n_heads"], m["n_kv_heads"],
                       m["head_dim"], m["vocab_size"])
    e = m["moe"]
    n = m["n_layers"] - 1
    bf = m["dtype"]
    out = [(("embed",), (v, d), bf, "normal", d)]

    def attn(pre, lead):
        return [(pre + ("wq",), lead + (d, h, hd), bf, "normal", d),
                (pre + ("wk",), lead + (d, kv, hd), bf, "normal", d),
                (pre + ("wv",), lead + (d, kv, hd), bf, "normal", d),
                (pre + ("wo",), lead + (h, hd, d), bf, "normal", h * hd)]

    def ffn(pre, lead, f):
        return [(pre + ("w_up",), lead + (d, f), bf, "normal", d),
                (pre + ("w_down",), lead + (f, d), bf, "normal", f),
                (pre + ("w_gate",), lead + (d, f), bf, "normal", d)]
    fl = ("first_layer",)
    out += [(fl + ("ln1",), (d,), bf, "zeros", 0)] + attn(fl + ("attn",), ())
    out += [(fl + ("ln2",), (d,), bf, "zeros", 0)]
    out += ffn(fl + ("ffn",), (), m["dense_first_d_ff"])
    ly = ("layers", 0)
    out += [(ly + ("ln1",), (n, d), bf, "zeros", 0)]
    out += attn(ly + ("attn",), (n,))
    out += [(ly + ("ln2",), (n, d), bf, "zeros", 0)]
    mo = ly + ("moe",)
    out += [(mo + ("router",), (n, d, e["n_experts"]), "float32", "normal", d)]
    ne, fe = e["n_experts"], e["d_expert"]
    out += [(mo + ("routed", "w_up"), (n, ne, d, fe), bf, "normal", d),
            (mo + ("routed", "w_down"), (n, ne, fe, d), bf, "normal", fe),
            (mo + ("routed", "w_gate"), (n, ne, d, fe), bf, "normal", d)]
    out += ffn(mo + ("shared",), (n,), e["n_shared"] * fe)
    out += [(("final_norm",), (d,), bf, "zeros", 0),
            (("lm_head",), (d, v), bf, "normal", d)]
    return out


def _leaves_mamba1(m: Dict) -> List[Tuple]:
    """Falcon-Mamba: Mamba-1 blocks only, untied head."""
    d, v, n = m["d_model"], m["vocab_size"], m["n_layers"]
    mb = m["mamba"]
    di, ds, dc, dtr = mb["d_inner"], mb["d_state"], mb["d_conv"], mb["dt_rank"]
    bf = m["dtype"]
    ly = ("layers", 0)
    mm = ly + ("mamba",)
    return [(("embed",), (v, d), bf, "normal", d),
            (ly + ("ln1",), (n, d), bf, "zeros", 0),
            (mm + ("in_proj",), (n, d, 2 * di), bf, "normal", d),
            (mm + ("conv_w",), (n, dc, di), bf, "normal", dc),
            (mm + ("conv_b",), (n, di), bf, "zeros", 0),
            (mm + ("x_proj",), (n, di, dtr + 2 * ds), bf, "normal", di),
            (mm + ("dt_proj",), (n, dtr, di), bf, "normal", dtr),
            (mm + ("dt_bias",), (n, di), bf, "dt_bias", 0),
            (mm + ("A_log",), (n, di, ds), "float32", "a_log", 0),
            (mm + ("D",), (n, di), "float32", "ones", 0),
            (mm + ("out_proj",), (n, di, d), bf, "normal", di),
            (("final_norm",), (d,), bf, "zeros", 0),
            (("lm_head",), (d, v), bf, "normal", d)]


FAMILIES = {"moe_attention": _leaves_moe_attention,
            "mamba1": _leaves_mamba1}


def leaves(config: Dict) -> List[Tuple]:
    return FAMILIES[config["family"]](config["model"])


def _put(tree, path, val):
    node = tree
    for k, nxt in zip(path[:-1], path[1:]):
        if isinstance(k, int):
            while len(node) <= k:
                node.append({})
            node = node[k]
        else:
            node = node.setdefault(k, [] if isinstance(nxt, int) else {})
    node[path[-1]] = val


def make(config: Dict, seed: int, device) -> Dict:
    """The parameter tree of ``config`` drawn from ``seed`` on ``device``."""
    specs = leaves(config)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    flat = {}
    for dt in sorted({s[2] for s in specs if s[3] == "normal"}):
        total = sum(math.prod(s[1]) for s in specs
                    if s[3] == "normal" and s[2] == dt)
        buf = torch.empty(total, dtype=_DT[dt], device=device)
        for i in range(0, total, CHUNK):
            buf[i:i + CHUNK].normal_(generator=gen)
        flat[dt] = [buf, 0]
    tree: Dict = {}
    for path, shape, dt, init, fan_in in specs:
        if init == "normal":
            buf, off = flat[dt]
            numel = math.prod(shape)
            t = buf[off:off + numel].view(shape)
            t.mul_(1.0 / math.sqrt(max(fan_in, 1)))
            flat[dt][1] = off + numel
        elif init == "zeros":
            t = torch.zeros(shape, dtype=_DT[dt], device=device)
        elif init == "ones":
            t = torch.ones(shape, dtype=_DT[dt], device=device)
        elif init == "dt_bias":         # softplus^-1(0.01)
            t = torch.full(shape, -4.6, dtype=_DT[dt], device=device)
        elif init == "a_log":
            a = torch.arange(1, shape[-1] + 1, dtype=torch.float32,
                             device=device)
            t = torch.log(a).expand(shape).contiguous().to(_DT[dt])
        else:
            raise ValueError(init)
        _put(tree, path, t)
    return tree

