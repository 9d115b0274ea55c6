"""The references against the program at small sizes on the CPU: the same
weights give the same logits, running statistics and parameter names, and
the plain optimizers step as torch.optim's."""

import pytest
import torch

from kfbench import spec
from kfbench.reference import bert, common, resnet
from kfbench.tests.tinyroot import TINY
from kungfu_tpu_torch.examples.bert_ssgd import flash_core, mlm_loss
from kungfu_tpu_torch.models.resnet import ResNet
from kungfu_tpu_torch.models.transformer import Transformer, TransformerConfig, transformer_apply

SEED = 2**31 + 12345


def _port_resnet(cfg, params, buffers):
    model = ResNet(cfg["stage_sizes"], cfg["num_classes"], cfg["num_filters"], torch.float32,
                   in_channels=cfg["in_channels"]).to(memory_format=torch.channels_last)
    drawn = {**params, **buffers}
    assert set(drawn) == {n for n, _ in model.named_parameters()} | {
        n for n, _ in model.named_buffers()}
    with torch.no_grad():
        for name, t in list(model.named_parameters()) + list(model.named_buffers()):
            t.copy_(drawn[name])
    return model


def test_resnet_reference_matches_the_port_in_float32():
    cfg = spec.config("resnet-tiny", TINY)
    params, buffers = resnet.init(cfg, SEED, "cpu")
    model = _port_resnet(cfg, params, buffers)
    images = torch.randn(4, cfg["image_size"], cfg["image_size"], 3,
                         generator=torch.Generator().manual_seed(0))
    want = model(images, train=True)
    got = resnet.logits(cfg, params, buffers, images)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    for name, b in model.named_buffers():
        torch.testing.assert_close(buffers[name], b, rtol=1e-4, atol=1e-6)


def test_resnet50_names_and_shapes_are_the_ports():
    cfg = spec.config("resnet50")
    pshapes, bshapes = resnet.shapes(cfg)
    model = ResNet(cfg["stage_sizes"], cfg["num_classes"], cfg["num_filters"])
    assert pshapes == {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert bshapes == {n: tuple(b.shape) for n, b in model.named_buffers()}


@pytest.mark.parametrize("core", ["full", "flash"])
def test_bert_reference_matches_the_port_in_float32(core):
    cfg = spec.config("bert-tiny", TINY)
    params, _ = bert.init(cfg, SEED, "cpu")
    tcfg = TransformerConfig(vocab_size=cfg["vocab_size"], d_model=cfg["hidden_size"],
                             n_heads=cfg["num_attention_heads"],
                             n_layers=cfg["num_hidden_layers"], d_ff=cfg["intermediate_size"],
                             max_seq=cfg["max_position_embeddings"], dtype=torch.float32)
    tree = {k: v for k, v in params.items() if "." not in k}
    tree["layers"] = {k.split(".", 1)[1]: v for k, v in params.items() if "." in k}
    model = Transformer(tcfg, tree)
    assert set(params) == {n for n, _ in model.named_parameters()}
    tokens = torch.randint(0, cfg["vocab_size"], (2, 32),
                           generator=torch.Generator().manual_seed(1))
    mask = torch.rand(2, 32, generator=torch.Generator().manual_seed(2)) < 0.3
    core_fn = flash_core if core == "flash" else None
    want = transformer_apply(model.tree(), tokens, tcfg, core=core_fn)
    torch.testing.assert_close(bert.logits(cfg, params, tokens), want, rtol=1e-4, atol=1e-5)
    want_loss = mlm_loss(model.tree(), tokens, tokens, mask, tcfg, core=core_fn)
    got_loss = bert.loss(cfg, params, {}, (tokens, tokens, mask))
    torch.testing.assert_close(got_loss, want_loss, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("spec_", [{"name": "sgd", "lr": 0.1, "momentum": 0.9},
                                   {"name": "adamw", "lr": 3e-4, "weight_decay": 0.01}])
def test_plain_optimizers_step_as_torch_optim(spec_):
    g = torch.Generator().manual_seed(3)
    start = {"a": torch.randn(5, 3, generator=g), "b": torch.randn(7, generator=g)}
    grads = [{k: torch.randn(v.shape, generator=g) for k, v in start.items()} for _ in range(3)]
    leaves = [torch.nn.Parameter(v.clone()) for v in start.values()]
    if spec_["name"] == "sgd":
        opt = torch.optim.SGD(leaves, lr=spec_["lr"], momentum=spec_["momentum"])
    else:
        opt = torch.optim.AdamW(leaves, lr=spec_["lr"], weight_decay=spec_["weight_decay"])
    plain = dict(start)
    step = common.optimizer(spec_)
    for t, gs in enumerate(grads):
        for p, k in zip(leaves, start):
            p.grad = gs[k].clone()
        opt.step()
        step(plain, gs, t)
    for p, k in zip(leaves, start):
        torch.testing.assert_close(plain[k], p.detach(), rtol=1e-6, atol=1e-7)


def test_fp8_rounding_is_coarser_than_bf16():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(4))
    err8 = ((common.round_fp8(x) - x).abs() / x.abs()).median()
    err16 = ((x.bfloat16().float() - x).abs() / x.abs()).median()
    assert err16 < err8 < 0.1


def _logits(family, cfg, precision):
    if family == "resnet":
        params, buffers = resnet.init(cfg, SEED, "cpu")
        images = torch.randn(4, cfg["image_size"], cfg["image_size"], 3,
                             generator=torch.Generator().manual_seed(5))
        return resnet.logits(cfg, params, buffers, images, precision)
    params, _ = bert.init(cfg, SEED, "cpu")
    tokens = torch.randint(0, cfg["vocab_size"], (2, 32),
                           generator=torch.Generator().manual_seed(5))
    return bert.logits(cfg, params, tokens, precision)


@pytest.mark.parametrize("family,name", [("resnet", "resnet-tiny"), ("bert", "bert-tiny")])
def test_the_control_rounds_the_f32_head_to_bf16(family, name):
    cfg = spec.config(name, TINY)
    exact = _logits(family, cfg, None)
    head = _logits(family, cfg, "bf16_head")
    control = _logits(family, cfg, "control")
    assert torch.equal(head, common.round_bf16(head))
    assert torch.equal(control, common.round_bf16(control))
    assert not torch.equal(head, exact)
    torch.testing.assert_close(head, exact, rtol=2e-2, atol=5e-3)
    assert not torch.equal(control, head)
