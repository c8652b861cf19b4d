"""InceptionV3's ``ConvBN`` with its BatchNorm folded into the convolution
(``models.inception``), on the CPU: the folded layer against the
composition it replaces, conv -> ``BatchNorm`` -> ReLU, in float64 to
1e-12 and in float32 to 8 ulps of the output's largest value (measured: at
most 3.7), for the kernel shapes of the network (1x1, 3x3 at stride 2
VALID, 1x7, 7x1) in both memory layouts; the kept fold following new
weights after a forward (``load_state_dict``, ``transplant.from_flax``, an
in-place ``copy_``, a new dtype); gradients through the fold equal to the
composition's; and the arguments of the route that float32 CUDA tensors
take (``torch.cudnn_convolution_relu``), given to a plain stand-in."""

import pytest
import torch
import torch.nn.functional as F

from masters_thesis_tpu_torch.models import inception
from masters_thesis_tpu_torch.models.inception import ConvBN, InceptionV3
from masters_thesis_tpu_torch.transplant import from_flax, to_flax

from torch_threads import one_thread  # noqa: F401

# (kernel, strides, padding) of the network's ConvBN kinds
KINDS = {"1x1": ((1, 1), (1, 1), "SAME"),
         "3x3-s2-valid": ((3, 3), (2, 2), "VALID"),
         "1x7": ((1, 7), (1, 1), "SAME"),
         "7x1": ((7, 1), (1, 1), "SAME")}
ULPS = {torch.float64: None, torch.float32: 8}
LAYOUTS = {"nchw": torch.contiguous_format,
           "channels_last": torch.channels_last}


def layer(kind: str, dtype=torch.float32, seed: int = 0) -> ConvBN:
    """A ConvBN of ``kind``, 6 -> 10 channels, its BatchNorm statistics and
    shift moved off their init values."""
    gen = torch.Generator().manual_seed(seed)
    kernel, strides, padding = KINDS[kind]
    m = ConvBN(6, 10, kernel, strides, padding, generator=gen).eval()
    with torch.no_grad():
        m.bn.mean.copy_(0.3 * torch.randn(10, generator=gen))
        m.bn.var.copy_(0.5 + 1.5 * torch.rand(10, generator=gen))
        m.bn.bias.copy_(0.1 * torch.randn(10, generator=gen))
    return m.to(dtype)


def unfolded(m: ConvBN, x: torch.Tensor) -> torch.Tensor:
    """What ConvBN computed before the fold."""
    return F.relu(m.bn(m.conv(x)))


def images(dtype, layout, seed: int = 1) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(2, 6, 11, 13, generator=gen, dtype=dtype).contiguous(
        memory_format=LAYOUTS[layout])


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("dtype", list(ULPS), ids=str)
def test_folded_conv_bn_is_conv_then_batchnorm_then_relu(dtype, kind,
                                                         layout):
    m = layer(kind, dtype)
    x = images(dtype, layout)
    with torch.no_grad():
        want = unfolded(m, x)
        got = m(x)
    scale = float(want.abs().max())
    atol = (1e-12 if dtype == torch.float64
            else ULPS[dtype] * torch.finfo(dtype).eps) * scale
    assert got.shape == want.shape
    assert got.is_contiguous(memory_format=LAYOUTS[layout])
    torch.testing.assert_close(got, want, rtol=0, atol=atol)
    assert float((want > 0).float().mean()) > 0.2      # the ReLU clips some


def _follows(m: ConvBN, x: torch.Tensor, change) -> None:
    """After a forward, ``change`` (new weights) is seen by the next."""
    with torch.no_grad():
        before = m(x).clone()
        change(m)
        want = unfolded(m, x)
        got = m(x)
    assert not torch.allclose(before, want)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=8e-7 * float(want.abs().max()))


@pytest.mark.parametrize("how", ["load_state_dict", "copy_", "bn_only"])
def test_the_kept_fold_follows_new_weights(how):
    m = layer("3x3-s2-valid")
    other = layer("3x3-s2-valid", seed=5)
    x = images(torch.float32, "channels_last")

    def change(m):
        if how == "load_state_dict":
            m.load_state_dict(other.state_dict())
        elif how == "copy_":
            m.conv.kernel.copy_(other.conv.kernel)
        else:
            m.bn.var.mul_(3.0)
            m.bn.mean.add_(0.5)
    _follows(m, x, change)


def test_the_kept_fold_follows_a_transplant_and_a_new_dtype():
    """``transplant.from_flax`` into a whole InceptionV3 after a forward,
    then ``.double()``: each next forward gives the unfolded network's
    patches."""
    gen = torch.Generator().manual_seed(0)
    model = InceptionV3(generator=gen).eval()
    source = InceptionV3(generator=gen).eval()
    x = torch.rand(1, 75, 75, 3, generator=gen) * 2 - 1

    def reference(model):
        saved = {}
        for name, mod in model.named_modules():
            if isinstance(mod, ConvBN):
                saved[name] = mod.forward
                mod.forward = (lambda m: lambda x: unfolded(m, x))(mod)
        try:
            return model(x.to(next(model.parameters()).dtype))["patches"]
        finally:
            for name, mod in model.named_modules():
                if name in saved:
                    del mod.forward

    with torch.no_grad():
        before = model(x)["patches"].clone()
        model.load_state_dict(from_flax(to_flax(source.state_dict())))
        got, want = model(x)["patches"], reference(model)
        assert not torch.allclose(before, want)
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))
        model.double()
        assert all(m._fold is None for m in model.modules()
                   if isinstance(m, ConvBN))       # no fold of the old dtype
        got, want = model(x.double())["patches"], reference(model)
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-12 * float(want.abs().max()))


@pytest.mark.parametrize("frozen", [False, True], ids=["trained", "frozen"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_gradients_through_the_fold_are_the_compositions(monkeypatch, kind,
                                                        frozen):
    """Under autograd the fold is made each call: the gradients of
    ``conv.kernel``, ``bn.bias`` and the input equal those of conv ->
    BatchNorm -> ReLU (float64), and the input's where the parameters are
    frozen; the cuDNN route, which has no backward, is not taken."""

    def cudnn_convolution_relu(*args):
        raise AssertionError("autograd took the cuDNN route")

    monkeypatch.setattr(inception, "_cudnn_fuses", lambda x: True)
    monkeypatch.setattr(torch, "cudnn_convolution_relu",
                        cudnn_convolution_relu)
    m = layer(kind, torch.float64).requires_grad_(not frozen)
    x = images(torch.float64, "nchw").requires_grad_()
    gen = torch.Generator().manual_seed(2)
    probe = None
    grads = []
    for forward in (m, lambda x: unfolded(m, x)):
        out = forward(x)
        if probe is None:
            probe = torch.randn(out.shape, generator=gen,
                                dtype=torch.float64)
        m.zero_grad()
        x.grad = None
        (out * probe).sum().backward()
        grads.append([x.grad.clone()] + ([] if frozen else [
            m.conv.kernel.grad.clone(), m.bn.bias.grad.clone()]))
    for got, want in zip(*grads):
        assert float(want.abs().max()) > 0
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-12 * float(want.abs().max()))


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("kind", list(KINDS))
def test_the_cudnn_route_gets_the_fold_padding_and_layout(monkeypatch, kind,
                                                          layout):
    """The call that float32 CUDA tensors make, given to a plain stand-in
    for ``torch.cudnn_convolution_relu`` on the CPU: the padded input, w'
    in the input's layout (no copy a call) and b', with the stride and the
    symmetric padding, give the composition's output."""
    calls = []

    def cudnn_convolution_relu(x, w, b, stride, padding, dilation, groups):
        calls.append((x.is_contiguous(memory_format=LAYOUTS[layout]),
                      w.is_contiguous(memory_format=LAYOUTS[layout])))
        return F.relu(F.conv2d(x, w, b, stride, padding, dilation, groups))

    monkeypatch.setattr(inception, "_cudnn_fuses", lambda x: True)
    monkeypatch.setattr(torch, "cudnn_convolution_relu",
                        cudnn_convolution_relu)
    m = layer(kind)
    x = images(torch.float32, layout)
    with torch.no_grad():
        want = unfolded(m, x)
        got = m(x)
    assert calls == [(True, True)]
    torch.testing.assert_close(got, want, rtol=0, atol=ULPS[torch.float32]
                               * torch.finfo(torch.float32).eps
                               * float(want.abs().max()))
