"""The plain reference (``reference/decoder.py``) held to the port on the
same weights and tokens, in float32 on the CPU at each configuration's
reduced size: logits, loss, every gradient, one AdamW step."""
import pytest
import torch

from portbench import program, weights
from portbench.reference import decoder

ARCHS = ["chatglm3-6b", "qwen3-14b"]
FIELDS = ("num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim",
          "d_ff", "vocab_size", "qk_norm", "rope_style", "rope_theta",
          "norm_eps", "pad_heads_to", "microbatches")
RTOL = 2e-4     # f32 on both sides: sums in other orders


def setup(arch, microbatches=2):
    from repro_torch.configs.registry import reduced_config
    from repro_torch.models import model_zoo
    cfg = reduced_config(arch, microbatches=microbatches, vocab_size=500)
    m = {key: getattr(cfg, key) for key in FIELDS}
    model = model_zoo.build_model(cfg)
    params = program.params(model, m, 11, "cpu")
    ref_params = {"global": weights.draw_global(m, 11, "cpu", torch.float32),
                  "layers": [weights.draw_layer(m, 11, i, "cpu",
                                                torch.float32)
                             for i in range(m["num_layers"])]}
    tokens = torch.randint(0, cfg.vocab_size, (2 * microbatches, 24),
                           generator=torch.Generator().manual_seed(3))
    return cfg, m, model, params, ref_params, tokens


def close(got, want, what):
    scale = want.abs().max().clamp(min=1e-30)
    err = float((got - want).abs().max() / scale)
    assert err < RTOL, f"{what}: {err}"


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_and_loss(arch):
    from repro_torch.models import transformer
    from repro_torch.train import steps
    cfg, m, model, params, ref_params, tokens = setup(arch)
    logits, _ = transformer.forward(cfg, params, tokens)
    dec = decoder.Decoder(m)
    with decoder.exact_float32():
        x, _ = dec.hidden(lambda i: ref_params["layers"][i],
                          ref_params["global"], tokens)
        want = dec.logits(ref_params["global"], x)
        loss = dec.loss(ref_params["global"], x, tokens)
    v = cfg.vocab_size
    close(logits[..., :v], want[..., :v], "logits")
    assert torch.isinf(want[..., v:]).all()
    got = steps.cross_entropy(logits[:, :-1], tokens[:, 1:], v)
    close(got, loss, "loss")
    last = dec.last_logits(lambda i: ref_params["layers"][i],
                           ref_params["global"], tokens)
    close(logits[:, -1, :v], last[:, :v], "last logits")


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_and_adamw_step(arch):
    from repro_torch.optim.adamw import AdamW, adamw_update, init_opt_state
    from repro_torch.train import steps
    cfg, m, model, params, ref_params, tokens = setup(arch)
    grads, total, _ = steps.make_grads_fn(cfg, model)(
        params, {"tokens": tokens, "labels": tokens})
    loss, ref_grads = decoder.Decoder(m).grads(ref_params, tokens,
                                               cfg.microbatches)
    assert abs(float(total) - loss) < RTOL * loss
    got = program.leaf_views(grads)
    want = decoder.leaves(ref_grads)
    assert set(got) == set(want)
    for name in want:
        close(got[name], want[name], name)

    # one AdamW step of each on the same gradient, the reference's (on
    # elements whose gradient is near nought Adam's step turns a rounding
    # difference of the gradient into a whole step)
    lr = 1e-2
    opt = AdamW()
    state = init_opt_state(params, opt)
    for name, g in program.leaf_views(grads).items():
        g.copy_(want[name])
    adamw_update(params, grads, state, lr, opt)
    decoder.adamw_step(ref_params, ref_grads, None, 1, lr=lr)
    new = program.leaf_views(params)
    for name, want_p in decoder.leaves(ref_params).items():
        close(new[name], want_p, name)


def test_padded_heads_are_zero_and_idle():
    """qwen3-14b's padded heads are zero in wq and wo, and the port's
    grouping puts q head h on kv head h // (Hp / K)."""
    from repro_torch.configs.registry import get_config
    cfg = get_config("qwen3-14b")
    m = {key: getattr(cfg, key) for key in FIELDS}
    m = dict(m, num_layers=1, d_model=64, d_ff=64, vocab_size=256)
    w = weights.draw_layer(m, 5, 0, "cpu", torch.float32)
    assert w["attn/wq"].shape[1] == 48
    assert not w["attn/wq"][:, 40:].any() and not w["attn/wo"][40:].any()
    assert w["attn/wq"][:, 39].any()
    assert decoder.Decoder(m).group == 6


def test_draws_repeat_by_layer():
    from repro_torch.configs.registry import reduced_config
    cfg = reduced_config("chatglm3-6b")
    m = {key: getattr(cfg, key) for key in FIELDS}
    a = weights.draw_layer(m, 2 ** 40 + 7, 1, "cpu")
    b = weights.draw_layer(m, 2 ** 40 + 7, 1, "cpu")
    c = weights.draw_layer(m, 2 ** 40 + 7, 0, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["attn/wq"], c["attn/wq"])
