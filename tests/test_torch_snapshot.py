"""The port's reader of reference training snapshots (``.pkl``) against
shgan_tpu's: the ref-free cases of tests/test_snapshot.py through both
loaders (equal dicts, the same refusals), the TF remap, and
``build_generator`` warm-starting from a ``.pkl`` (a reference-format
pickle of the port's own G_ema, and a legacy TF pickle)."""

import io
import pickle
import sys
import types

import numpy as np
import pytest
import torch

from shgan_tpu.checkpoint import load_network_snapshot as j_load
from shgan_tpu.checkpoint import tf_params_to_torch_state_dict as j_remap
from shgan_tpu.checkpoint.snapshot import _load_primitive as j_primitive
from shgan_tpu.runtime.stages import build_generator as j_build
from shgan_torch.checkpoint import load_network_snapshot as t_load
from shgan_torch.checkpoint import tf_params_to_torch_state_dict as t_remap
from shgan_torch.checkpoint.snapshot import _load_primitive as t_primitive
from shgan_torch.models import get_model
from shgan_torch.runtime.stages import build_generator as t_build

from test_torch_models import REPO, tiny_cfg


def _equal_data(a, b):
    assert set(a) == set(b)
    for name in a:
        if a[name] is None or b[name] is None:
            assert a[name] is b[name] is None, name
            continue
        assert list(a[name]) == list(b[name]), name
        for k in a[name]:
            assert a[name][k].dtype == b[name][k].dtype, (name, k)
            np.testing.assert_array_equal(a[name][k], b[name][k],
                                          err_msg=f"{name}.{k}")


class _BufModule(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(3, 2)
        self.register_buffer("keep", torch.arange(4.))
        self.register_buffer("skip", torch.zeros(2), persistent=False)
        self.strided = torch.nn.Parameter(
            torch.arange(12.).reshape(3, 4).t())


def test_strided_and_nonpersistent_match_jax(tmp_path):
    """Strided tensors rebuild, non-persistent buffers are left out, and
    the dicts equal JAX's and the module's state_dict."""
    m = _BufModule()
    path = tmp_path / "s.pkl"
    with open(path, "wb") as f:
        pickle.dump({"G": m, "D": None, "G_ema": None,
                     "augment_pipe": None}, f)
    prefixes = ("tests.", "test_")
    got, is_tf = t_load(str(path), extra_stub_prefixes=prefixes)
    want, _ = j_load(str(path), extra_stub_prefixes=prefixes)
    assert not is_tf and "skip" not in got["G"]
    _equal_data(got, want)
    for k, v in m.state_dict().items():
        np.testing.assert_array_equal(got["G"][k], v.numpy(), err_msg=k)


class _Evil:
    def __reduce__(self):
        return (exec, ("import os",))


@pytest.mark.parametrize("payload", ["pytest_global", "exec"])
def test_refuses_what_jax_refuses(tmp_path, payload):
    """A global outside the allowlist, and a REDUCE of ``exec``, refuse in
    both loaders; so does any class in a legacy storage stream's framing,
    while primitives load."""
    obj = ({"G": pytest.ExitCode.OK} if payload == "pytest_global"
           else {"G": _Evil()})
    path = tmp_path / "evil.pkl"
    path.write_bytes(pickle.dumps(obj))
    for load in (t_load, j_load):
        with pytest.raises(pickle.UnpicklingError, match="refusing"):
            load(str(path))
    for prim in (t_primitive, j_primitive):
        with pytest.raises(pickle.UnpicklingError, match="refusing"):
            prim(io.BytesIO(pickle.dumps(_Evil())))
        assert prim(io.BytesIO(pickle.dumps([1, "a", {2: 3}]))) == \
            [1, "a", {2: 3}]


@pytest.fixture()
def dnnlib():
    """The ``dnnlib.tflib.network.Network`` class the TF pickles carry."""
    dnn = types.ModuleType("dnnlib")
    tflib = types.ModuleType("dnnlib.tflib")
    netmod = types.ModuleType("dnnlib.tflib.network")

    class Network:
        pass

    Network.__module__ = "dnnlib.tflib.network"
    Network.__qualname__ = "Network"
    netmod.Network = Network
    dnn.tflib, tflib.network = tflib, netmod
    sys.modules.update({"dnnlib": dnn, "dnnlib.tflib": tflib,
                        "dnnlib.tflib.network": netmod})
    yield Network
    for k in ("dnnlib", "dnnlib.tflib", "dnnlib.tflib.network"):
        sys.modules.pop(k, None)


def test_legacy_tf_pickle_matches_jax(tmp_path, dnnlib):
    """A tuple of TF Network stubs → slash-named variable dicts, recursing
    into components, equal to JAX's; version < 4 refused by both."""
    def net(prefix, components=None):
        n = dnnlib()
        n.version = 4
        n.variables = [(f"{prefix}/w", np.ones((2, 2), np.float32)),
                       (f"{prefix}/b", np.zeros(2, np.float32))]
        n.components = components or {}
        return n

    g = net("G_mapping", components={"sub": net("inner")})
    path = tmp_path / "tf.pkl"
    with open(path, "wb") as f:
        pickle.dump((g, net("D"), net("Gs")), f)
    got, is_tf = t_load(str(path))
    want, _ = j_load(str(path))
    assert is_tf and "sub/inner/w" in got["G"] and "Gs/b" in got["G_ema"]
    _equal_data(got, want)
    g.version = 3
    with open(path, "wb") as f:
        pickle.dump((g,), f)
    for load in (t_load, j_load):
        with pytest.raises(ValueError, match="version"):
            load(str(path))


def _tf_vars(seed=0):
    """TF CoModGAN variables of every kind the remap knows, and strays."""
    rng = np.random.RandomState(seed)

    def cw(o, i, k=3):
        return rng.randn(k, k, i, o).astype(np.float32)

    def dw(o, i):
        return rng.randn(i, o).astype(np.float32)

    def v(*s):
        return rng.randn(*s).astype(np.float32)
    return {
        "mapping/Dense0/weight": dw(16, 16), "mapping/Dense0/bias": v(16),
        "mapping/Dense1/weight": dw(16, 16), "dlatent_avg": v(16),
        "synthesis/4x4/Const/const": v(1, 8, 4, 4),
        "synthesis/4x4/Dense0/weight": dw(8 * 16, 16),
        "synthesis/4x4/Conv/weight": cw(8, 8),
        "synthesis/4x4/Conv/mod_weight": dw(8, 32),
        "synthesis/4x4/Conv/mod_bias": v(8),
        "synthesis/4x4/Conv/noise_strength": np.float32(0.25),
        "synthesis/4x4/ToRGB/weight": cw(3, 8, 1),
        "synthesis/8x8/Conv0_up/weight": cw(8, 8),
        "synthesis/8x8/Conv1/weight": cw(8, 8),
        "synthesis/noise0": v(1, 1, 4, 4), "synthesis/noise1": v(1, 1, 8, 8),
        "synthesis/noise2": v(1, 1, 8, 8),
        "synthesis/E_8x8/FromRGB/weight": cw(8, 4, 1),
        "synthesis/E_8x8/Conv1_down/weight": cw(8, 8),
        "synthesis/E_4x4/Dense0/weight": dw(16, 8 * 16),
        "synthesis/8x8/Conv0_up/resample_kernel": np.ones((4, 4),
                                                          np.float32),
        "lod": np.float32(0), "some/unknown/thing": np.zeros(3, np.float32),
    }


def test_tf_remap_matches_jax():
    """Names, layouts (HWIO → OIHW, [in, out] → [out, in]), the +1 of the
    style bias, scalar noise strengths, the noise buffers, the encoder's
    scopes and the unmatched report: equal to JAX's, key order included."""
    tf = _tf_vars()
    got, got_un = t_remap(tf)
    want, want_un = j_remap(tf)
    assert list(got) == list(want) and got_un == want_un == [
        "some/unknown/thing"]
    for k in want:
        assert np.shape(got[k]) == np.shape(want[k]), k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _tf_pickle(path, dnnlib, G_sd, seed=1):
    """A legacy TF pickle ``(G, D, Gs)`` whose Gs holds ``dlatent_avg``,
    the mapping's first dense layer and the 4² conv, shaped for ``G_sd``."""
    rng = np.random.RandomState(seed)
    o, i, kh, kw = G_sd["synthesis.b4.conv.weight"].shape
    gs = dnnlib()
    gs.version, gs.components = 4, {}
    gs.variables = [
        ("dlatent_avg", rng.randn(*G_sd["mapping.w_avg"].shape)
         .astype(np.float32)),
        ("mapping/Dense0/weight", rng.randn(
            *G_sd["mapping.fc0.weight"].shape[::-1]).astype(np.float32)),
        ("mapping/Dense0/bias", rng.randn(
            *G_sd["mapping.fc0.bias"].shape).astype(np.float32)),
        ("synthesis/4x4/Conv/weight", rng.randn(kh, kw, i, o)
         .astype(np.float32)),
        ("synthesis/4x4/Conv/noise_strength", np.float32(0.3)),
        ("some/stray", np.zeros(2, np.float32))]
    g = dnnlib()
    g.version, g.components, g.variables = 4, {}, []
    with open(path, "wb") as f:
        pickle.dump((g, g, gs), f)
    return dict(gs.variables)


def test_tf_warm_start_matches_jax(tmp_path, dnnlib, capsys):
    """``build_generator(.pkl)`` of a TF pickle: the remapped leaves equal
    JAX's, every other leaf keeps the port's own init (a non-strict
    merge), and the unmatched variables are logged in one line, as JAX logs
    them."""
    cfg = tiny_cfg(32)
    init = get_model(cfg, seed=0).state_dict()
    tf = _tf_pickle(tmp_path / "tf.pkl", dnnlib, init)
    G = t_build(cfg, str(tmp_path / "tf.pkl"))
    _, jparams = j_build(cfg, str(tmp_path / "tf.pkl"))
    sd = G.state_dict()
    remapped = {"mapping.w_avg", "mapping.fc0.weight", "mapping.fc0.bias",
                "synthesis.b4.conv.weight",
                "synthesis.b4.conv.noise_strength"}
    for k in remapped:
        node = jparams
        for part in k.split("."):
            node = node[part]
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(node),
                                      err_msg=k)
    np.testing.assert_array_equal(sd["mapping.w_avg"].numpy(),
                                  tf["dlatent_avg"])
    for k, v in init.items():
        if k not in remapped:
            torch.testing.assert_close(sd[k], v, rtol=0, atol=0, msg=k)
    out = capsys.readouterr().out
    assert out.count("TF pickle: 1 unmatched variables (first: "
                     "['some/stray'])") == 2   # the port's line and JAX's


def test_reference_format_pickle_round_trip(tmp_path):
    """chip_smoke.py's reference-format pickle of a port G_ema (modules of
    classes named ``lib.model_zoo.comodgan.*``): both loaders read its
    state_dict back bit for bit, and ``build_generator`` gives the same
    weights from it as from the ``.pth`` with ``snapshot_key`` picking the
    network."""
    import importlib
    sys.path.insert(0, REPO)
    smoke = importlib.import_module("chip_smoke")
    cfg = tiny_cfg(32)
    G = get_model(cfg, seed=5)
    pkl = smoke.reference_pickle(G, str(tmp_path / "network-snapshot-1.pkl"))
    want = {k: v.numpy() for k, v in G.state_dict().items()}
    for load in (t_load, j_load):
        data, is_tf = load(pkl)
        assert not is_tf and data["G"] is None
        assert set(data["G_ema"]) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(data["G_ema"][k], v, err_msg=k)
    pth = str(tmp_path / "g.pth")
    torch.save(G.state_dict(), pth)
    a = t_build(cfg, pkl).state_dict()
    b = t_build(cfg, pth).state_dict()
    for k in b:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)
    with pytest.raises(KeyError, match="holds no G"):
        t_build(cfg, pkl, snapshot_key="G")   # None in this snapshot
    jG, jparams = j_build(cfg, pkl)
    x = np.random.RandomState(0).randn(1, 4, 32, 32).astype(np.float32)
    z = np.random.RandomState(1).randn(1, 32).astype(np.float32)
    with torch.no_grad():
        got = G(torch.from_numpy(x), torch.from_numpy(z),
                noise_mode="const").numpy()
    want_img = np.asarray(jG(jparams, x, z, noise_mode="const"))
    np.testing.assert_allclose(got, want_img, rtol=1e-4, atol=2e-4)
