"""The RWKV-6 "Finch" family (arXiv:2404.05892): the block (a time mix
with the data-dependent token shift and decay and the WKV recurrence
computed token by token, s_t = diag(w_t) s_{t-1} + k_t^T v_t, out_t = r_t
(s_{t-1} + diag(u) k_t^T v_t), a per-head group norm and a SiLU gate; a
channel mix with a squared ReLU), its parameter layout in the port's
names, and its leaves' rules for ``colonybench.weights``."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import models

EPS_KEY = "layer_norm_epsilon"
ATTENTION = False


def layout(cfg: dict) -> dict:
    """One stacked block's shapes, keys in the port's names."""
    d, layers, f = cfg["hidden_size"], cfg["num_hidden_layers"], cfg["intermediate_size"]
    lm, lw = cfg["mix_lora"], cfg["decay_lora"]
    sq = (layers, d, d)
    return {
        "norm1": {"scale": (layers, d), "bias": (layers, d)},
        "mixer": {"mu_x": (layers, d), "mu": (layers, 5, d), "mix_a": (layers, d, 5 * lm),
                  "mix_b": (layers, 5, lm, d), "w0": (layers, d), "w_a": (layers, d, lw),
                  "w_b": (layers, lw, d), "u": (layers, d), "wr": sq, "wk": sq, "wv": sq,
                  "wg": sq, "wo": sq, "ln_x": {"scale": (layers, d), "bias": (layers, d)}},
        "mlp": {"mu_k": (layers, d), "mu_r": (layers, d), "wk": (layers, d, f),
                "wv": (layers, f, d), "wr": sq},
        "norm2": {"scale": (layers, d), "bias": (layers, d)},
    }


def fill(name: str, t: torch.Tensor, cfg: dict) -> bool:
    """The token-shift mixes in (0, 1); the decays spread over the channels
    as RWKV-6 initialises them; the bonus; the LoRAs moving the mixes and
    decays by about 0.5; and the residual branches' outputs (the time
    mix's ``wo``, the channel mix's ``wv``) scaled by
    ``init_residual_scale`` as GPT-2 initialises them."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("mu_x", "mu", "mu_k", "mu_r"):
        t.sigmoid_()
    elif leaf == "w0":
        d = t.shape[-1]
        ramp = torch.arange(d, device=t.device, dtype=t.dtype) / (d - 1)
        t.mul_(0.3).add_(-6.0 + 5.0 * ramp**0.9)
    elif leaf == "u":
        t.mul_(0.5)
    elif leaf in ("mix_b", "w_b"):
        t.mul_(0.5 / math.sqrt(t.shape[-2]))
    elif name.endswith(("mixer.wo", "mlp.wv")) and cfg.get("init_residual_scale"):
        t.mul_(cfg["init_residual_scale"] / math.sqrt(t.shape[1]))
    else:
        return False
    return True


def sizes(cfg: dict, program) -> tuple[dict, dict]:
    """(the file's sizes, the program configuration's) to compare. The
    LoRA widths are not among them: the port's time mix reads them from
    the shapes of ``mix_b`` and ``w_b``, which the benchmark's weights
    give."""
    want = {"d_model": cfg["hidden_size"], "num_layers": cfg["num_hidden_layers"],
            "d_ff": cfg["intermediate_size"], "vocab_size": cfg["vocab_size"],
            "norm_eps": cfg["layer_norm_epsilon"], "head_size": cfg["head_size"]}
    got = {k: getattr(program, k) for k in ("d_model", "num_layers", "d_ff", "vocab_size",
                                             "norm_eps")}
    got.update(head_size=program.rwkv.head_size)
    return want, got


def _time_mix(p: dict, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    b, t, d = x.shape
    hs = cfg["head_size"]
    nh = d // hs
    dx = models._shift(x) - x
    xx = x + dx * p["mu_x"]
    lora = torch.tanh(models._einsum("btd,dl->btl", xx, p["mix_a"])).reshape(b, t, 5, -1)
    dyn = models._einsum("btnl,nld->btnd", lora, p["mix_b"])
    mixed = [x + dx * (p["mu"][i] + dyn[:, :, i]) for i in range(5)]  # r k v w g
    r, k, v = (models._einsum("btd,de->bte", m, p[w])
               for m, w in zip(mixed[:3], ("wr", "wk", "wv")))
    g = F.silu(models._einsum("btd,de->bte", mixed[4], p["wg"]))
    lora = torch.tanh(models._einsum("btd,dl->btl", mixed[3], p["w_a"]))
    decay_lora = models._einsum("btl,ld->btd", lora, p["w_b"])
    w = torch.exp(-torch.exp(torch.clamp(p["w0"] + decay_lora, -12.0, 4.0)))
    r, k, v, w = (a.reshape(b, t, nh, hs) for a in (r, k, v, w))
    u = p["u"].reshape(nh, hs)
    state = torch.zeros(b, nh, hs, hs, device=x.device, dtype=torch.float32)
    out = torch.empty_like(v)
    for i in range(t):
        kv = k[:, i, :, :, None] * v[:, i, :, None, :]
        out[:, i] = models._einsum("bhk,bhkv->bhv", r[:, i], state + u[None, :, :, None] * kv)
        state = state * w[:, i, :, :, None] + kv
    mu = out.mean(-1, keepdim=True)
    var = (out - mu).square().mean(-1, keepdim=True)
    normed = ((out - mu) / torch.sqrt(var + 64e-5)).reshape(b, t, d)
    normed = normed * p["ln_x"]["scale"] + p["ln_x"]["bias"]
    return models._einsum("btd,de->bte", normed * g, p["wo"])


def _channel_mix(p: dict, x: torch.Tensor) -> torch.Tensor:
    dx = models._shift(x) - x
    xk, xr = x + dx * p["mu_k"], x + dx * p["mu_r"]
    kk = torch.relu(models._einsum("btd,df->btf", xk, p["wk"])).square()
    gate = torch.sigmoid(models._einsum("btd,de->bte", xr, p["wr"]))
    return gate * models._einsum("btf,fd->btd", kk, p["wv"])


def block(p: dict, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    eps = cfg["layer_norm_epsilon"]
    norm1, norm2 = p["norm1"], p["norm2"]
    x = x + _time_mix(p["mixer"], models._layer_norm(x, norm1["scale"], norm1["bias"], eps), cfg)
    return x + _channel_mix(p["mlp"], models._layer_norm(x, norm2["scale"], norm2["bias"], eps))
