"""Reference training snapshots (``network-snapshot-*.pkl``) read with
``pickle`` and numpy alone (port of ``shgan_tpu/checkpoint/snapshot.py``
with the parts of ``torch_reader.py`` it uses).

The reference's train stage pickles ``{'G', 'D', 'G_ema', 'augment_pipe'}``
as whole torch modules, not state_dicts; its eval stage also takes legacy
TensorFlow CoModGAN pickles (a tuple of ``dnnlib.tflib.network.Network``).
Neither is ever unpickled with torch's own classes:

* the module classes (``torch.nn.*``, ``torch.optim.*``, the reference's
  ``lib.*`` model zoo, ``easydict``) become inert attribute-bag stubs,
  walked afterwards with ``nn.Module.state_dict`` semantics (parameters,
  persistent buffers, submodules);
* a tensor's storage is the legacy ``torch.save`` stream that
  ``torch.storage._load_from_bytes`` would read, parsed here: its framing
  pickles admit primitives only, and its one storage is read as raw
  little-endian bytes;
* any other global outside an explicit set of side-effect-free builtins
  and numpy constructors is refused.

This file never calls ``torch.load`` or a bare ``pickle.load`` on a
``.pkl``.  :func:`tf_params_to_torch_state_dict` maps a TF pickle's
variables to the reference's torch names.
"""

from __future__ import annotations

import io
import pickle
import re
import struct

import numpy as np

_DTYPE_BY_STORAGE = {
    "FloatStorage": np.float32,
    "DoubleStorage": np.float64,
    "HalfStorage": np.float16,
    "LongStorage": np.int64,
    "IntStorage": np.int32,
    "ShortStorage": np.int16,
    "CharStorage": np.int8,
    "ByteStorage": np.uint8,
    "BoolStorage": np.bool_,
    "BFloat16Storage": "bfloat16",  # resolved through ml_dtypes when used
}


class _AttrDict(dict):
    """A dict that takes attribute assignment (``OrderedDict._metadata``)."""


class _StorageType:
    def __init__(self, name):
        self.name = name

    @property
    def dtype(self):
        d = _DTYPE_BY_STORAGE[self.name]
        if d == "bfloat16":
            import ml_dtypes
            return np.dtype(ml_dtypes.bfloat16)
        return np.dtype(d)


def _rebuild_tensor_v2(storage, storage_offset, size, stride,
                       requires_grad=False, backward_hooks=None,
                       metadata=None):
    # offset, size and stride come from the untrusted pickle: bound-check
    # them before as_strided, which would otherwise view memory outside
    # the storage
    size, stride = tuple(int(s) for s in size), tuple(int(s) for s in stride)
    if (storage_offset < 0 or storage_offset > storage.size
            or len(size) != len(stride)
            or any(s < 0 for s in size) or any(s < 0 for s in stride)):
        raise ValueError(f"tensor header out of bounds: offset="
                         f"{storage_offset} size={size} stride={stride} "
                         f"storage numel={storage.size}")
    flat = storage[storage_offset:]
    if len(size) == 0:
        if flat.size < 1:
            raise ValueError("scalar tensor beyond end of storage")
        return flat[:1].reshape(())
    if 0 not in size:
        last = sum((s - 1) * st for s, st in zip(size, stride))
        if last >= flat.size:
            raise ValueError(
                f"tensor extent {last + 1} exceeds storage remainder "
                f"{flat.size} (offset={storage_offset} size={size} "
                f"stride={stride})")
    arr = np.lib.stride_tricks.as_strided(
        flat, shape=size,
        strides=tuple(s * flat.dtype.itemsize for s in stride))
    return np.ascontiguousarray(arr)


def _rebuild_parameter(data, requires_grad=True, backward_hooks=None):
    return data


# side-effect-free constructors only: a blanket builtins passthrough would
# hand a crafted pickle exec / eval / getattr through REDUCE
_SAFE_BUILTINS = frozenset({
    "list", "dict", "tuple", "set", "frozenset", "slice", "complex",
    "bytearray", "range", "int", "float", "bool", "str", "bytes",
})
_SAFE_NUMPY = frozenset({
    "ndarray", "dtype", "scalar", "_reconstruct", "_frombuffer",
})


def _safe_stdlib_class(module, name, fallback):
    """An allowlisted builtins or numpy name, else a refusal."""
    if module == "builtins" and name in _SAFE_BUILTINS:
        return fallback(module, name)
    if module in ("numpy", "numpy.core.multiarray",
                  "numpy._core.multiarray") and name in _SAFE_NUMPY:
        return fallback(module, name)
    raise pickle.UnpicklingError(
        f"refusing to unpickle {module}.{name} from checkpoint")


class _PrimitiveUnpickler(pickle.Unpickler):
    """The framing pickles of a legacy storage stream (magic number,
    protocol, sys_info, key list): primitives only, no class at all."""

    def find_class(self, module, name):
        raise pickle.UnpicklingError(
            f"refusing {module}.{name} in legacy-storage framing")


def _load_primitive(f):
    return _PrimitiveUnpickler(f).load()


_STUB_PREFIXES = ("torch.nn.", "torch.optim.", "lib.", "easydict")


class _ModuleStub:
    """Inert stand-in for a pickled torch module: BUILD fills __dict__."""

    _origin = None  # (module, name) the stub replaced


class _TFNetworkStub(_ModuleStub):
    pass


_stub_cache = {}


def _stub_class(module, name):
    key = (module, name)
    if key not in _stub_cache:
        _stub_cache[key] = type(name, (_ModuleStub,),
                                {"_origin": key, "__module__": module})
    return _stub_cache[key]


def _storage_from_bytes(blob):
    """The flat numpy array of the legacy ``torch.save`` stream that
    ``Tensor.__reduce_ex__`` embeds (``torch.storage._load_from_bytes``)."""
    f = io.BytesIO(bytes(blob))
    if _load_primitive(f) != 0x1950A86A20F9469CFC6C:
        raise pickle.UnpicklingError("bad legacy-storage magic number")
    _load_primitive(f)  # protocol_version
    _load_primitive(f)  # sys_info
    spec = {}

    class _P(pickle.Unpickler):
        def find_class(self, module, name):
            if module == "torch" and name in _DTYPE_BY_STORAGE:
                return _StorageType(name)
            raise pickle.UnpicklingError(
                f"refusing {module}.{name} in legacy storage")

        def persistent_load(self, pid):
            if pid[0] != "storage":
                raise pickle.UnpicklingError(f"unknown pid {pid!r}")
            storage_type, key, _loc, numel = pid[1], pid[2], pid[3], pid[4]
            spec["dtype"] = storage_type.dtype
            spec["key"] = str(key)
            spec["numel"] = int(numel)
            return spec

    if _P(f).load() is not spec:
        raise pickle.UnpicklingError("legacy storage stream: unexpected obj")
    arrays = {}
    for key in _load_primitive(f):
        (numel,) = struct.unpack("<q", f.read(8))
        if str(key) != spec["key"]:
            # a foreign key's itemsize is unknown: guessing would misalign
            # every later key; Tensor.__reduce_ex__ writes one storage
            raise pickle.UnpicklingError(
                f"legacy storage stream carries unexpected key {key!r} "
                f"(expected only {spec['key']!r}) — cannot size its "
                "payload safely")
        dt = spec["dtype"]
        arrays[str(key)] = np.frombuffer(
            f.read(numel * dt.itemsize), dtype=dt, count=numel)
    return arrays[spec["key"]]


class _SnapshotUnpickler(pickle.Unpickler):
    stub_prefixes = _STUB_PREFIXES

    def find_class(self, module, name):
        if module == "torch._utils" and name == "_rebuild_tensor_v2":
            return _rebuild_tensor_v2
        if module == "torch._utils" and name == "_rebuild_parameter":
            return _rebuild_parameter
        if module == "torch.storage" and name == "_load_from_bytes":
            return _storage_from_bytes
        if module == "torch" and name in _DTYPE_BY_STORAGE:
            return _StorageType(name)
        if module == "torch" and name == "Size":
            return tuple
        if module == "collections" and name == "OrderedDict":
            return _AttrDict
        if module == "dnnlib.tflib.network" and name == "Network":
            return _TFNetworkStub
        if module.startswith(tuple(self.stub_prefixes)):
            return _stub_class(module, name)
        return _safe_stdlib_class(module, name, super().find_class)


def _module_state_dict(stub, prefix=""):
    """``nn.Module.state_dict()`` over an unpickled module stub."""
    out = {}
    d = stub.__dict__
    for k, v in (d.get("_parameters") or {}).items():
        if v is not None:
            out[prefix + k] = np.asarray(v)
    skip = d.get("_non_persistent_buffers_set") or set()
    for k, v in (d.get("_buffers") or {}).items():
        if v is not None and k not in skip:
            out[prefix + k] = np.asarray(v)
    for k, v in (d.get("_modules") or {}).items():
        if v is not None:
            out.update(_module_state_dict(v, prefix + k + "."))
    return out


def _collect_tf_params(net, prefix=""):
    """The variables of a TF ``Network`` stub and of its components,
    ``{slash/path: array}``."""
    out = {}
    for name, value in net.__dict__.get("variables", []):
        out[prefix + name] = np.asarray(value)
    for name, comp in (net.__dict__.get("components") or {}).items():
        out.update(_collect_tf_params(comp, prefix + name + "/"))
    return out


def load_network_snapshot(path, extra_stub_prefixes=()):
    """Load a reference ``network-snapshot-*.pkl`` → ``(data,
    is_tensorflow)``.

    * A torch snapshot: ``data`` is ``{'G': flat_sd, 'D': flat_sd,
      'G_ema': flat_sd, 'augment_pipe': None}``, flat ``{name: ndarray}``
      state_dicts.
    * A legacy TF pickle (a tuple of Networks ``(G, D, Gs)``): the same
      keys map to the raw ``{tf/var/path: array}`` dicts (Gs → 'G_ema').

    ``extra_stub_prefixes`` widens the module-class allowlist (a snapshot
    written by a copy of the model zoo under another package name)."""
    with open(path, "rb") as f:
        up = _SnapshotUnpickler(f)
        up.stub_prefixes = _STUB_PREFIXES + tuple(extra_stub_prefixes)
        obj = up.load()

    if isinstance(obj, tuple) and obj and all(
            isinstance(n, _TFNetworkStub) for n in obj):
        for n in obj:
            if n.__dict__.get("version", 0) < 4:
                raise ValueError("TensorFlow pickle version too low")
        return {name: _collect_tf_params(net)
                for name, net in zip(("G", "D", "G_ema"), obj)}, True

    if not isinstance(obj, dict):
        raise ValueError(
            f"unrecognized snapshot payload: {type(obj).__name__}")
    data = {}
    for name, val in obj.items():
        if val is None:
            data[name] = None
        elif isinstance(val, _ModuleStub):
            data[name] = _module_state_dict(val)
        else:
            data[name] = np.asarray(val)
    return data, False


# ---------------------------------------------------------------------------
# legacy TF CoModGAN name remap
# ---------------------------------------------------------------------------

def _tf_conv_w(v):
    """TF conv weight [kh, kw, in, out] → torch OIHW."""
    return np.ascontiguousarray(np.asarray(v).transpose(3, 2, 0, 1))


def _tf_dense_w(v):
    """TF dense weight [in, out] → torch [out, in]."""
    return np.ascontiguousarray(np.asarray(v).T)


def _tf_layer_entries(tf_params, tf_scope, torch_prefix, out):
    """One TF conv / modconv / dense layer scope → torch names.  ``weight``
    transposes by rank; ``mod_weight`` / ``mod_bias`` become the style
    ``affine`` (the torch layer keeps the style bias' +1 init in the
    parameter, TF adds it at run time); ``noise_strength`` is a scalar."""
    hits = 0
    for suffix, value in list(tf_params.items()):
        if not suffix.startswith(tf_scope + "/"):
            continue
        leaf = suffix[len(tf_scope) + 1:]
        if "/" in leaf:
            continue
        v = np.asarray(value)
        if leaf == "weight":
            out[f"{torch_prefix}.weight"] = (_tf_conv_w(v) if v.ndim == 4
                                             else _tf_dense_w(v))
        elif leaf == "bias":
            out[f"{torch_prefix}.bias"] = v
        elif leaf == "mod_weight":
            out[f"{torch_prefix}.affine.weight"] = _tf_dense_w(v)
        elif leaf == "mod_bias":
            out[f"{torch_prefix}.affine.bias"] = v + 1.0
        elif leaf == "noise_strength":
            out[f"{torch_prefix}.noise_strength"] = v.reshape(())
        else:
            continue
        hits += 1
    return hits


def tf_params_to_torch_state_dict(tf_params):
    """Legacy-TF CoModGAN generator variables (``{tf/slash/path: array}``
    from :func:`load_network_snapshot`) → the reference's torch
    state_dict names, for a non-strict merge (a warm start).

    The scopes follow the public co-mod-gan TF release: ``mapping/
    Dense{i}``, ``dlatent_avg``, ``synthesis/{r}x{r}/{Conv0_up,Conv1,
    ToRGB}``, ``synthesis/4x4/{Const,Dense0,Conv}``, ``synthesis/noise{i}``
    and the encoder's ``[synthesis/]E_{r}x{r}/{FromRGB,Conv0,Conv1_down}``
    + ``E_4x4/{Conv,Dense0,Dense1}``.  TF pickles hold no SHU: its
    parameters keep their init under the merge.

    Returns ``(state_dict, unmatched_tf_keys)``."""
    out = {}
    consumed = set()

    def layer(tf_scope, torch_prefix):
        if _tf_layer_entries(tf_params, tf_scope, torch_prefix, out):
            consumed.add(tf_scope)

    # the mapping network and w_avg
    for key in tf_params:
        m = re.fullmatch(r"(?:mapping/)?Dense(\d+)/weight", key)
        if m:
            layer(key[:-len("/weight")], f"mapping.fc{m.group(1)}")
    if "dlatent_avg" in tf_params:
        out["mapping.w_avg"] = np.asarray(tf_params["dlatent_avg"])
        consumed.add("dlatent_avg")

    # the synthesis pyramid
    resolutions = sorted({
        int(m.group(1)) for k in tf_params
        for m in [re.match(r"synthesis/(\d+)x\1/", k)] if m})
    for r in resolutions:
        sc = f"synthesis/{r}x{r}"
        if r == 4:
            const = tf_params.get(f"{sc}/Const/const")
            if const is not None:
                c = np.asarray(const)
                out["synthesis.b4.const"] = (c[0] if c.ndim == 4
                                             and c.shape[0] == 1 else c)
                consumed.add(f"{sc}/Const")
            layer(f"{sc}/Dense0", "synthesis.b4.fc")
            layer(f"{sc}/Conv", "synthesis.b4.conv")
        else:
            layer(f"{sc}/Conv0_up", f"synthesis.b{r}.conv0")
            layer(f"{sc}/Conv1", f"synthesis.b{r}.conv1")
        layer(f"{sc}/ToRGB", f"synthesis.b{r}.torgb")

    # the per-layer noise buffers: noise0 → b4.conv, then (conv0, conv1)
    # a doubling resolution
    for key in list(tf_params):
        m = re.fullmatch(r"(?:synthesis/)?noise(\d+)", key)
        if not m:
            continue
        i = int(m.group(1))
        v = np.asarray(tf_params[key])
        v = v.reshape(v.shape[-2:])
        if i == 0:
            name = "synthesis.b4.conv.noise_const"
        else:
            r = 4 * (2 ** ((i + 1) // 2))
            name = f"synthesis.b{r}.conv{(i + 1) % 2}.noise_const"
        out[name] = v
        consumed.add(key)

    # the encoder pyramid (co-mod-gan keeps E_* inside G_synthesis; a
    # component of its own is accepted too)
    for key in list(tf_params):
        m = re.match(r"(?:synthesis/)?(E_(\d+)x\2)/", key)
        if not m:
            continue
        sc, r = key[:key.index(m.group(1)) + len(m.group(1))], int(m.group(2))
        if r == 4:
            layer(f"{sc}/Conv", "encoder.b4.conv")
            layer(f"{sc}/Dense0", "encoder.b4.fc")
            layer(f"{sc}/Dense1", "encoder.b4.out")
        else:
            layer(f"{sc}/FromRGB", f"encoder.b{r}.fromrgb")
            layer(f"{sc}/Conv0", f"encoder.b{r}.conv0")
            layer(f"{sc}/Conv1_down", f"encoder.b{r}.conv1")

    matched = {k for sc in consumed for k in tf_params
               if k == sc or k.startswith(sc + "/")}
    # resample kernels and lod counters are constants of the torch modules
    unmatched = sorted(k for k in tf_params if k not in matched
                       and not k.endswith("resample_kernel")
                       and k.rsplit("/", 1)[-1] != "lod")
    return out, unmatched
