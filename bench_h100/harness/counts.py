"""Operations and bytes from shapes: the yardstick of `mfu.*` and the
`roofline.*` metrics.

Operations are the logical multiply-adds of the products (2 per MAC) that
the model's mathematics needs: convolutions, linear layers, attention's
two products, and MoEfication's second FF product over the selected share
k / E of the experts only (the routing adds each neuron's gate into its
expert's score once, N * H additions). Norms, activations and other
elementwise work are not counted. Bytes count each input read once and each
output written once, in the dtype served (bf16: 2 bytes, norm parameters
f32: 4), whatever a kernel reads again.

Peaks: one NVIDIA H100 SXM, dense bf16 on the tensor cores and HBM3, from
NVIDIA's data sheet, at its 700 W limit.
"""
from __future__ import annotations

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
BF16 = 2
CROSS = ("CrossAttnDownBlock2D", "CrossAttnUpBlock2D")


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take for the work."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def conv(h: int, w: int, cin: int, cout: int, k: int = 3) -> float:
    return 2.0 * h * w * cin * cout * k * k


def linear(n: int, cin: int, cout: int) -> float:
    return 2.0 * n * cin * cout


def experts(c: int, mult: int, moe: dict) -> tuple:
    """(H, E, k) of an FF of width c under MoEfication."""
    h = mult * c
    e = h // moe["expert_size"]
    return h, e, max(int(e * moe["topk_ratio"]), 1)


def ff(n: int, c: int, mult: int, moe) -> tuple:
    """(operations, bytes) of one GEGLU FF over n tokens of width c, its
    LayerNorm and residual included (the port's FF module absorbs them):
    x in, LN scale and shift, W1 and b1, W2 and b2, the (E, H) expert
    membership in, y out. `moe` None: dense."""
    if moe is None:
        h, share, adds = mult * c, 1.0, 0.0
        pat = 0
    else:
        h, e, k = experts(c, mult, moe)
        share, adds, pat = k / e, float(n * h), e * h * BF16
    flops = linear(n, c, 2 * h) + adds + linear(n, h, c) * share
    nbytes = (2 * n * c * BF16 + 2 * c * 4 + (2 * h * c + 2 * h) * BF16
              + (h * c + c) * BF16 + pat)
    return flops, nbytes


def self_attn(b: int, s: int, c: int) -> tuple:
    """(operations, bytes) of one self-attention over b x s tokens of width
    c: q, k, v and out projections (out with its bias) and the two
    products; x in, the four weights, y out."""
    flops = 4 * linear(b * s, c, c) + 4.0 * b * s * s * c
    nbytes = (2 * b * s * c + 4 * c * c + c) * BF16
    return flops, nbytes


def cross_attn(b: int, s: int, c: int, l: int, d_ctx: int) -> float:
    return (2 * linear(b * s, c, c) + 2 * linear(b * l, d_ctx, c)
            + 4.0 * b * s * l * c)


def per_block(v, i):
    return v if isinstance(v, int) else v[i]


def unet_call(u: dict, moe, batch: int, side: int, ctx_len: int) -> float:
    """Operations of one UNet call at `batch` samples of side x side
    latents with a context of `ctx_len` tokens."""
    ch = list(u["block_out_channels"])
    n, tdim, mult = len(ch), 4 * ch[0], u["ff_mult"]
    d_ctx = u["cross_attention_dim"]
    total = 2.0 * (ch[0] * tdim + tdim * tdim)
    if u.get("addition_embed_dim"):
        total += 2.0 * ((u["addition_embed_dim"]
                         + 6 * u["addition_time_embed_dim"]) * tdim + tdim * tdim)
    per = [0.0]

    def resnet(s, cin, cout):
        per[0] += conv(s, s, cin, cout) + conv(s, s, cout, cout) + 2.0 * tdim * cout
        if cin != cout:
            per[0] += conv(s, s, cin, cout, 1)

    def transformer(s, c, i):
        t = s * s
        per[0] += 2 * linear(t, c, c)
        for _ in range(per_block(u["transformer_layers_per_block"], i)):
            per[0] += (self_attn(1, t, c)[0] + cross_attn(1, t, c, ctx_len, d_ctx)
                       + ff(t, c, mult, moe)[0])

    s, cur = side, ch[0]
    per[0] += conv(s, s, u["in_channels"], ch[0])
    skips = [cur]
    for i, kind in enumerate(u["down_block_types"]):
        for _ in range(u["layers_per_block"]):
            resnet(s, cur, ch[i])
            cur = ch[i]
            if kind in CROSS:
                transformer(s, cur, i)
            skips.append(cur)
        if i < n - 1:
            s //= 2
            per[0] += conv(s, s, cur, cur)
            skips.append(cur)
    resnet(s, cur, cur)
    transformer(s, cur, n - 1)
    resnet(s, cur, cur)
    for i, kind in enumerate(u["up_block_types"]):
        out = ch[n - 1 - i]
        for _ in range(u["layers_per_block"] + 1):
            resnet(s, cur + skips.pop(), out)
            cur = out
            if kind in CROSS:
                transformer(s, cur, n - 1 - i)
        if i < n - 1:
            s *= 2
            per[0] += conv(s, s, cur, cur)
    per[0] += conv(s, s, ch[0], u["out_channels"])
    return batch * (total + per[0])


def text_tower(t: dict, seqs: int, projection: bool = False) -> float:
    """Operations of a CLIP text tower over `seqs` sequences (the causal
    products counted whole, as computed)."""
    l, d, i = t["max_length"], t["hidden_size"], t["intermediate_size"]
    layer = 4 * linear(l, d, d) + 4.0 * l * l * d + 2 * linear(l, d, i)
    return seqs * (t["num_layers"] * layer + (linear(1, d, d) if projection
                                              else 0.0))


def vae_decode(v: dict, images: int, side: int) -> float:
    """Operations of the VAE decoder over `images` latents of side x side."""
    rev = list(reversed(v["block_out_channels"]))
    lc, s = v["latent_channels"], side
    f = conv(s, s, lc, lc, 1) + conv(s, s, lc, rev[0])

    def resnet(s, cin, cout):
        r = conv(s, s, cin, cout) + conv(s, s, cout, cout)
        return r + (conv(s, s, cin, cout, 1) if cin != cout else 0.0)

    t = s * s
    f += 2 * resnet(s, rev[0], rev[0]) + 4 * linear(t, rev[0], rev[0]) \
        + 4.0 * t * t * rev[0]
    for i, c in enumerate(rev):
        for j in range(v["layers_per_block"] + 1):
            f += resnet(s, rev[max(i - 1, 0)] if j == 0 else c, c)
        if i < len(rev) - 1:
            s *= 2
            f += conv(s, s, c, c)
    f += conv(s, s, rev[-1], v["out_channels"])
    return images * f


def unet_calls(cfg: dict, steps: int) -> int:
    """UNet calls of a generate: PLMS repeats one step."""
    return steps + 1 if cfg["scheduler"]["name"] == "pndm" else steps


def generate(cfg: dict, images: int, steps: int, guidance: float) -> float:
    """Operations of a generate of `images` requests: both prompts' text
    encodes, every UNet call (batch 2B under classifier-free guidance),
    the decode."""
    cfgs = 2 if guidance > 1.0 else 1
    towers = cfg["text_encoders"]
    ctx = towers[0]["max_length"]
    f = sum(text_tower(t, 2 * images, projection=(j == len(towers) - 1
                                                  and cfg["pipeline"] == "sdxl"))
            for j, t in enumerate(towers))
    f += unet_calls(cfg, steps) * unet_call(cfg["unet"], cfg["moe"],
                                            cfgs * images, cfg["sample_size"], ctx)
    return f + vae_decode(cfg["vae"], images, cfg["sample_size"])
