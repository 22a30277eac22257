"""ONNX export without the `onnx` package: a walk of a `torch.export` graph into ONNX nodes, written by a
minimal protobuf wire-format writer (counterpart of `lpc_yolo_tpu/engine/onnx_export.py`).

torch's own ONNX exporters need the `onnx` and `onnxscript` packages. This module needs neither: ONNX models
are protobuf messages, and encoding one is varints and length-delimited fields, so the writer below
(`_varint` .. `_model_proto`, the port's own copy of the JAX package's :50-176) implements the subset ONNX
needs. The artifact is checked by OpenCV's dnn ONNX importer, an independent decoder and runtime
(`tests/test_torch_export.py`).

Steps:
  1. `torch.export.export(module, (example,))` on the f32 export graph (static shapes) gives a graph of ATen
     operators over the module's parameters, buffers, constants and the one input.
  2. Every node whose inputs are all constants is computed once and becomes a constant (an initializer where
     a node reads it): aranges, anchors, the folded weights' permutes and casts.
  3. Nodes that carry no value are dropped: `_assert_tensor_metadata`, `detach`, `contiguous`, `clone`,
     `alias`, and a `to.dtype` that keeps the dtype.
  4. Every other node goes through the emitter registered for its ATen target (`_emit`); a target with no
     emitter raises NotImplementedError naming it. Nothing is skipped.
  5. A Transpose of a Transpose is one Transpose, or none where the two cancel, so the NHWC views of the
     conv3x3 sites' plain version leave plain Conv nodes between NCHW tensors; nodes no output reads are
     dropped.

Where the op sets differ: `log1p` is Log(Add(x, 1)) (ONNX has no Log1p); a softmax over another axis than the
last is transposed to the last, since opset 12's Softmax flattens from its axis on; the nearest upsample is a
Resize (nearest, asymmetric, floor); `topk` / `gather` are TopK / GatherElements; LayerNorm, GroupNorm and GELU,
which opset 12 lacks, are their formulas. Targets opset 12 and ir_version 7, as the JAX converter does.
"""

from __future__ import annotations

import math
import operator
import struct
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# --------------------------------------------------------------------------
# protobuf wire format (the subset ONNX needs: varint, length-delimited, fixed32 for AttributeProto.f)
# --------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # negative int64 -> two's complement, per the proto spec
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _vint(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(int(value))


def _blob(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _string(field: int, s: str) -> bytes:
    return _blob(field, s.encode("utf-8"))


def _fixed32(field: int, f: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", float(f))


# TensorProto.DataType
_DT = {
    np.dtype(np.float32): 1, np.dtype(np.uint8): 2, np.dtype(np.int8): 3, np.dtype(np.int32): 6,
    np.dtype(np.int64): 7, np.dtype(np.bool_): 9, np.dtype(np.float16): 10, np.dtype(np.float64): 11,
}
_TORCH_NP = {torch.float32: np.float32, torch.float64: np.float64, torch.float16: np.float16, torch.int64: np.int64,
             torch.int32: np.int32, torch.int8: np.int8, torch.uint8: np.uint8, torch.bool: np.bool_}


def _onnx_dtype(dtype) -> int:
    dt = np.dtype(_TORCH_NP[dtype] if isinstance(dtype, torch.dtype) and dtype in _TORCH_NP else dtype)
    if dt not in _DT:
        raise NotImplementedError(f"ONNX export: unsupported dtype {dtype}")
    return _DT[dt]


def _tensor_proto(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    out = b"".join(_vint(1, d) for d in arr.shape)
    out += _vint(2, _onnx_dtype(arr.dtype))
    out += _string(8, name)
    out += _blob(9, arr.tobytes())  # raw_data, little-endian
    return out


def _attr(name: str, value) -> bytes:
    out = _string(1, name)
    if isinstance(value, (bool, int, np.integer)):
        out += _vint(3, int(value)) + _vint(20, 2)  # i / INT
    elif isinstance(value, float):
        out += _fixed32(2, value) + _vint(20, 1)  # f / FLOAT
    elif isinstance(value, str):
        out += _blob(4, value.encode()) + _vint(20, 3)  # s / STRING
    elif isinstance(value, (list, tuple)) and all(isinstance(v, (int, np.integer)) for v in value):
        out += b"".join(_vint(8, int(v)) for v in value) + _vint(20, 7)  # ints / INTS
    elif isinstance(value, (list, tuple)) and all(isinstance(v, float) for v in value):
        out += b"".join(_fixed32(7, v) for v in value) + _vint(20, 6)  # floats / FLOATS
    else:
        raise TypeError(f"attribute {name}: unsupported value {value!r}")
    return out


def _node_proto(op: str, inputs: Sequence[str], outputs: Sequence[str], name: str, attrs: Dict[str, Any]) -> bytes:
    out = b"".join(_string(1, i) for i in inputs)
    out += b"".join(_string(2, o) for o in outputs)
    out += _string(3, name) + _string(4, op)
    out += b"".join(_blob(5, _attr(k, v)) for k, v in attrs.items())
    return out


def _value_info(name: str, shape: Sequence[int], dtype) -> bytes:
    dims = b"".join(_blob(1, _vint(1, d)) for d in shape)  # TensorShapeProto.Dimension.dim_value
    tensor_type = _vint(1, _onnx_dtype(dtype)) + _blob(2, dims)
    return _string(1, name) + _blob(2, _blob(1, tensor_type))


def _model_proto(nodes: List[bytes], initializers: List[bytes], inputs: List[bytes], outputs: List[bytes],
                 graph_name: str, opset: int = 12) -> bytes:
    graph = b"".join(_blob(1, n) for n in nodes)
    graph += _string(2, graph_name)
    graph += b"".join(_blob(5, t) for t in initializers)
    graph += b"".join(_blob(11, vi) for vi in inputs)
    graph += b"".join(_blob(12, vi) for vi in outputs)
    model = _vint(1, 7)  # ir_version 7
    model += _string(2, "lpc_yolo_tpu_torch")
    model += _string(3, "1.0")
    model += _blob(7, graph)
    model += _blob(8, _string(1, "") + _vint(2, opset))  # opset_import
    return model


# --------------------------------------------------------------------------
# the graph being built
# --------------------------------------------------------------------------

_FOLD_LIMIT_BYTES = 1 << 22  # a folded constant larger than this and than its inputs (a broadcast) stays a node


class _Const:
    """A value known at export time: a tensor, or a Python scalar or list."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value


class _Builder:
    """ONNX nodes and initializers; each Transpose's source, so that a chain of them collapses."""

    def __init__(self):
        self.nodes: List[Tuple[str, List[str], List[str], Dict[str, Any]]] = []
        self.initializers: Dict[str, np.ndarray] = {}
        self.transposes: Dict[str, Tuple[str, List[int]]] = {}  # output -> (input, perm)
        self._n = 0

    def fresh(self, hint: str = "t") -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def const(self, arr, hint: str = "c") -> str:
        name = self.fresh(hint)
        self.initializers[name] = np.asarray(arr)
        return name

    def i64(self, values: Sequence[int], hint: str = "shape") -> str:
        return self.const(np.asarray(list(values), np.int64), hint)

    def add(self, op: str, inputs: Sequence[str], n_out: int = 1, **attrs) -> List[str]:
        outs = [self.fresh(op.lower()) for _ in range(n_out)]
        self.nodes.append((op, list(inputs), outs, attrs))
        return outs

    def add1(self, op: str, inputs: Sequence[str], **attrs) -> str:
        return self.add(op, inputs, 1, **attrs)[0]

    def transpose(self, x: str, perm: Sequence[int]) -> str:
        perm = [int(p) for p in perm]
        src = self.transposes.get(x)
        if src is not None:  # Transpose(Transpose(y, p1), p2) = Transpose(y, p1[p2])
            x, perm = src[0], [src[1][p] for p in perm]
        if perm == list(range(len(perm))):
            return x
        out = self.add1("Transpose", [x], perm=perm)
        self.transposes[out] = (x, perm)
        return out

    def used(self, outputs: Sequence[str]) -> List[Tuple[str, List[str], List[str], Dict[str, Any]]]:
        """The nodes that the graph's outputs read, in order."""
        need, keep = set(outputs), []
        for node in reversed(self.nodes):
            if any(o in need for o in node[2]):
                keep.append(node)
                need.update(i for i in node[1] if i)
        return keep[::-1]


# --------------------------------------------------------------------------
# torch.export graph -> ONNX
# --------------------------------------------------------------------------

_DROP = {"aten._assert_tensor_metadata.default", "aten._assert_scalar.default"}
_IDENTITY = {"aten.detach.default", "aten.contiguous.default", "aten.clone.default", "aten.alias.default",
             "aten.lift_fresh_copy.default", "aten.dropout.default"}


def _meta(node):
    """The FakeTensor (or tuple of them) the node produces: shapes and dtypes."""
    return node.meta["val"]


class _Converter:
    def __init__(self, builder: _Builder):
        self.b = builder
        self.env: Dict[Any, Any] = {}

    # -- values --------------------------------------------------------------
    def value(self, arg):
        """An fx argument as a _Const, an ONNX tensor name or a list of either."""
        if isinstance(arg, torch.fx.Node):
            return self.env[arg]
        if isinstance(arg, (list, tuple)):
            return [self.value(a) for a in arg]
        return _Const(arg)

    def name(self, arg, dtype=None) -> str:
        """An ONNX tensor name for an argument; a constant becomes an initializer (of `dtype` for a scalar)."""
        v = self.value(arg) if not isinstance(arg, (_Const, str)) else arg
        if isinstance(v, str):
            return v
        val = v.value
        if isinstance(val, torch.Tensor):
            return self.b.const(val.detach().numpy(), "w")
        if dtype is None:
            raise NotImplementedError(f"ONNX export: a constant {val!r} with no dtype to give it")
        return self.b.const(np.asarray(val, _TORCH_NP[dtype]), "s")

    def run(self, ep) -> None:
        sig = {s.arg.name: s for s in ep.graph_signature.input_specs}
        consts = {**ep.state_dict, **ep.constants}
        for node in ep.graph.nodes:
            if node.op == "placeholder":
                spec = sig[node.name]
                if spec.kind.name == "USER_INPUT":
                    self.env[node] = "images"
                else:
                    self.env[node] = _Const(consts[spec.target])
            else:
                self.step(node, ep.graph_module)

    def step(self, node, root) -> None:
        """One non-placeholder node; `root` holds the submodules that get_attr nodes name."""
        if node.op == "get_attr":
            attr = getattr(root, node.target)
            self.env[node] = _Const(attr) if isinstance(attr, torch.Tensor) else attr
        elif node.op == "call_function":
            self.call(node)

    def inline(self, gm, args) -> list:
        """The outputs of a submodule's graph (the body of a higher-order op) on these argument values."""
        child = _Converter(self.b)
        phs = [n for n in gm.graph.nodes if n.op == "placeholder"]
        for ph, a in zip(phs, args):
            child.env[ph] = a
        for n in gm.graph.nodes:
            if n.op != "placeholder":
                child.step(n, gm)
        out = next(n for n in gm.graph.nodes if n.op == "output").args[0]
        return [child.value(o) for o in out]

    def call(self, node) -> None:
        key = str(node.target)
        if key in _DROP:
            self.env[node] = None
            return
        args = [self.value(a) for a in node.args]
        if key in _IDENTITY or key == "aten.to.dtype" and _meta(node.args[0]).dtype == node.args[1]:
            self.env[node] = args[0]
            return
        if self._foldable(node, args):
            return
        emitter = _EMITTERS.get(key)
        if emitter is None:
            shapes = [tuple(_meta(a).shape) for a in node.args if isinstance(a, torch.fx.Node)
                      and isinstance(_meta(a), torch.Tensor)]
            raise NotImplementedError(f"ONNX export: ATen target '{key}' has no emitter (input shapes {shapes}); "
                                      f"extend lpc_yolo_tpu_torch/engine/onnx_export.py")
        self.env[node] = emitter(self, node)

    def _foldable(self, node, args) -> bool:
        """Compute a node whose inputs are all constants once, unless it broadcasts into a large constant."""
        def known(v):
            return isinstance(v, _Const) or isinstance(v, list) and all(known(x) for x in v)

        if not all(known(a) for a in args) or not all(known(self.value(v)) for v in node.kwargs.values()):
            return False
        out = _meta(node) if node.target is not operator.getitem else None
        if isinstance(out, torch.Tensor):
            in_bytes = sum(a.value.numel() * a.value.element_size() for a in args
                           if isinstance(a, _Const) and isinstance(a.value, torch.Tensor))
            if out.numel() * out.element_size() > max(_FOLD_LIMIT_BYTES, in_bytes):
                return False

        def real(v):
            return [real(x) for x in v] if isinstance(v, list) else v.value

        with torch.no_grad():
            val = node.target(*[real(a) for a in args], **{k: real(self.value(v)) for k, v in node.kwargs.items()})
        self.env[node] = _Const(val) if not isinstance(val, (tuple, list)) else [_Const(v) for v in val]
        return True


_EMITTERS: Dict[str, Callable] = {}


def _emit(*keys: str):
    def deco(fn):
        for k in keys:
            _EMITTERS[k] = fn
        return fn

    return deco


def _args(node) -> list:
    """The node's arguments by position in its ATen schema, keyword arguments placed and defaults filled in."""
    out = []
    for i, arg in enumerate(node.target._schema.arguments):
        if i < len(node.args):
            out.append(node.args[i])
        elif arg.name in node.kwargs:
            out.append(node.kwargs[arg.name])
        else:
            out.append(arg.default_value if arg.has_default_value() else None)
    return out


def _out_dtype(node):
    return _meta(node).dtype


def _shape(node) -> List[int]:
    return [int(d) for d in _meta(node).shape]


def _rank(arg) -> int:
    return len(_meta(arg).shape)


def _axis(d: int, rank: int) -> int:
    return d + rank if d < 0 else d


# -- elementwise --------------------------------------------------------------


def _binary(op: str):
    def fn(c: _Converter, node):
        dt = _out_dtype(node)
        names = []
        for arg in node.args[:2]:
            n = c.name(arg, dt)
            if isinstance(arg, torch.fx.Node) and _meta(arg).dtype != dt:
                n = c.b.add1("Cast", [n], to=_onnx_dtype(dt))
            names.append(n)
        a = _args(node)
        alpha = a[2] if len(a) > 2 else 1
        if alpha != 1:
            names[1] = c.b.add1("Mul", [names[1], c.name(_Const(alpha), dt)])
        return c.b.add1(op, names)

    return fn


for _k, _op in {"add.Tensor": "Add", "sub.Tensor": "Sub", "mul.Tensor": "Mul", "div.Tensor": "Div",
                "pow.Tensor_Scalar": "Pow"}.items():
    _EMITTERS[f"aten.{_k}"] = _binary(_op)


@_emit("aten.div.Tensor_mode")
def _div_mode(c, node):
    """Integer division truncating: ONNX Div. Other rounding is refused."""
    mode = node.kwargs.get("rounding_mode")
    dt = _out_dtype(node)
    if mode != "trunc" or dt.is_floating_point:
        raise NotImplementedError(f"ONNX export: division of {dt} with rounding_mode={mode!r}")
    return c.b.add1("Div", [c.name(node.args[0], dt), c.name(node.args[1], dt)])


@_emit("aten.fmod.Scalar")
def _fmod(c, node):
    dt = _out_dtype(node)
    return c.b.add1("Mod", [c.name(node.args[0], dt), c.name(node.args[1], dt)], fmod=1)


def _unary(op: str):
    def fn(c, node):
        return c.b.add1(op, [c.name(node.args[0])])

    return fn


for _k, _op in {"neg": "Neg", "abs": "Abs", "exp": "Exp", "sigmoid": "Sigmoid", "relu": "Relu", "sin": "Sin",
                "cos": "Cos"}.items():
    _EMITTERS[f"aten.{_k}.default"] = _unary(_op)


def _tanh_of(c, x: str, dt) -> str:
    """Tanh of x clipped to [-15, 15]: OpenCV 5.0's Tanh gives NaN past |x| ~ 44 (Mish's softplus reaches it), and
    the f32 tanh is exactly +-1 from |x| = 9.01 on, so the clip changes no value."""
    x = c.b.add1("Min", [c.b.add1("Max", [x, c.name(_Const(-15.0), dt)]), c.name(_Const(15.0), dt)])
    return c.b.add1("Tanh", [x])


@_emit("aten.tanh.default")
def _tanh(c, node):
    return _tanh_of(c, c.name(node.args[0]), _out_dtype(node))


@_emit("aten.log1p.default")
def _log1p(c, node):
    x = c.name(node.args[0])
    return c.b.add1("Log", [c.b.add1("Add", [x, c.name(_Const(1.0), _out_dtype(node))])])


@_emit("aten.silu.default")
def _silu(c, node):
    x = c.name(node.args[0])
    return c.b.add1("Mul", [x, c.b.add1("Sigmoid", [x])])


@_emit("aten.leaky_relu.default")
def _leaky_relu(c, node):
    return c.b.add1("LeakyRelu", [c.name(node.args[0])], alpha=float(_args(node)[1]))


@_emit("aten.gelu.default")
def _gelu(c, node):
    """GELU as its formula (ONNX has Gelu from opset 20): tanh form or erf form."""
    x = c.name(node.args[0])
    dt = _out_dtype(node)
    k = lambda v: c.name(_Const(v), dt)  # noqa: E731
    if _args(node)[1] == "tanh":  # in this order: OpenCV 5.0's importer crashes on (x * (1 + tanh)) * 0.5
        cube = c.b.add1("Mul", [c.b.add1("Mul", [x, x]), x])
        inner = c.b.add1("Mul", [c.b.add1("Add", [x, c.b.add1("Mul", [cube, k(0.044715)])]),
                                 k(math.sqrt(2.0 / math.pi))])
        return c.b.add1("Mul", [c.b.add1("Mul", [x, k(0.5)]), c.b.add1("Add", [_tanh_of(c, inner, dt), k(1.0)])])
    half = c.b.add1("Add", [c.b.add1("Erf", [c.b.add1("Div", [x, k(math.sqrt(2.0))])]), k(1.0)])
    return c.b.add1("Mul", [c.b.add1("Mul", [x, half]), k(0.5)])


@_emit("aten.clamp.default", "aten.clamp_min.default")
def _clamp(c, node):
    """clamp as Max / Min with constants of the tensor's dtype (Clip's optional inputs trip some importers)."""
    a = _args(node)
    lo, hi = a[1], a[2] if len(a) > 2 else None
    dt = _out_dtype(node)
    y = c.name(node.args[0])
    if lo is not None:
        y = c.b.add1("Max", [y, c.name(_Const(lo), dt)])
    if hi is not None:
        y = c.b.add1("Min", [y, c.name(_Const(hi), dt)])
    return y


@_emit("aten.to.dtype")
def _cast(c, node):
    return c.b.add1("Cast", [c.name(node.args[0])], to=_onnx_dtype(_out_dtype(node)))


# -- shapes ---------------------------------------------------------------------


@_emit("aten.view.default", "aten.reshape.default", "aten.flatten.using_ints", "aten.unsqueeze.default")
def _reshape(c, node):
    return c.b.add1("Reshape", [c.name(node.args[0]), c.b.i64(_shape(node))])


@_emit("aten.permute.default")
def _permute(c, node):
    return c.b.transpose(c.name(node.args[0]), [_axis(d, _rank(node.args[0])) for d in node.args[1]])


@_emit("aten.transpose.int")
def _transpose(c, node):
    r = _rank(node.args[0])
    perm = list(range(r))
    d0, d1 = _axis(node.args[1], r), _axis(node.args[2], r)
    perm[d0], perm[d1] = perm[d1], perm[d0]
    return c.b.transpose(c.name(node.args[0]), perm)


@_emit("aten.expand.default", "aten.expand_as.default")
def _expand(c, node):
    return c.b.add1("Expand", [c.name(node.args[0]), c.b.i64(_shape(node))])


@_emit("aten.slice.Tensor")
def _slice(c, node):
    x, dim, start, end, step = _args(node)
    size = _meta(x).shape[_axis(dim, _rank(x))]
    start = 0 if start is None else start
    end = size if end is None else min(end, size)
    return c.b.add1("Slice", [c.name(x), c.b.i64([start]), c.b.i64([end]), c.b.i64([_axis(dim, _rank(x))]),
                              c.b.i64([step])])


@_emit("aten.narrow.default")
def _narrow(c, node):
    x, dim, start, length = _args(node)
    d = _axis(dim, _rank(x))
    return c.b.add1("Slice", [c.name(x), c.b.i64([start]), c.b.i64([start + length]), c.b.i64([d])])


@_emit("aten.select.int")
def _select(c, node):
    x, dim, index = node.args
    return c.b.add1("Gather", [c.name(x), c.b.const(np.asarray(index, np.int64), "idx")], axis=_axis(dim, _rank(x)))


@_emit("aten.cat.default")
def _cat(c, node):
    dt = _out_dtype(node)
    parts = [p for p in node.args[0] if not (isinstance(p, torch.fx.Node) and 0 in _meta(p).shape)]
    return c.b.add1("Concat", [c.name(p, dt) for p in parts], axis=_axis(_args(node)[1], _rank(node)))


@_emit("aten.stack.default")
def _stack(c, node):
    dim = _axis(_args(node)[1], _rank(node))
    parts = []
    for p in node.args[0]:
        shape = list(_meta(p).shape)
        parts.append(c.b.add1("Reshape", [c.name(p), c.b.i64(shape[:dim] + [1] + shape[dim:])]))
    return c.b.add1("Concat", parts, axis=dim)


def _split(c, node, sizes, dim):
    return c.b.add("Split", [c.name(node.args[0])], n_out=len(sizes), axis=_axis(dim, _rank(node.args[0])),
                   split=[int(s) for s in sizes])


@_emit("aten.split_with_sizes.default")
def _split_with_sizes(c, node):
    a = _args(node)
    return _split(c, node, a[1], a[2])


@_emit("aten.split.Tensor", "aten.chunk.default")
def _split_like(c, node):
    dim = _axis(_args(node)[2], _rank(node.args[0]))
    return _split(c, node, [o.shape[dim] for o in _meta(node)], dim)


@_emit("aten.unbind.int")
def _unbind(c, node):
    dim = _args(node)[1]
    outs = _meta(node)
    names = _split(c, node, [1] * len(outs), dim)
    return [c.b.add1("Reshape", [n, c.b.i64(list(o.shape))]) for n, o in zip(names, outs)]


@_emit("wrap_with_autocast")
def _wrap(c, node):
    """A region under autocast (World's f32 heads): its body inlined, since the export graph is f32 throughout."""
    return c.inline(c.value(node.args[4]), [c.value(a) for a in node.args[5:]])


@_emit("<built-in function getitem>")
def _getitem(c, node):
    return c.value(node.args[0])[node.args[1]]


@_emit("aten.gather.default")
def _gather(c, node):
    x, dim, index = node.args[:3]
    return c.b.add1("GatherElements", [c.name(x), c.name(index)], axis=_axis(dim, _rank(x)))


@_emit("aten.topk.default")
def _topk(c, node):
    x, k, dim, largest, sorted_ = _args(node)
    return c.b.add("TopK", [c.name(x), c.b.i64([k], "k")], n_out=2, axis=_axis(dim, _rank(x)), largest=int(largest),
                   sorted=int(sorted_))


@_emit("aten.pad.default")
def _pad(c, node):
    x, torch_pads, mode, value = _args(node)
    if mode != "constant":
        raise NotImplementedError(f"ONNX export: {mode} padding")
    value = 0 if value is None else value
    r = _rank(x)
    lo, hi = [0] * r, [0] * r
    for i in range(len(torch_pads) // 2):  # torch pads the last dim first
        lo[r - 1 - i], hi[r - 1 - i] = torch_pads[2 * i], torch_pads[2 * i + 1]
    if any(p < 0 for p in lo + hi):
        raise NotImplementedError("ONNX export: negative padding")
    return c.b.add1("Pad", [c.name(x), c.b.i64(lo + hi, "pads"), c.name(_Const(value), _out_dtype(node))],
                    mode="constant")


# -- reductions -------------------------------------------------------------------


def _reduce(op: str):
    def fn(c, node):
        x, dims, keep = _args(node)[:3]
        dims = list(range(_rank(x))) if dims in (None, []) else [dims] if isinstance(dims, int) else dims
        y = c.name(x)
        if _meta(x).dtype != _out_dtype(node):
            y = c.b.add1("Cast", [y], to=_onnx_dtype(_out_dtype(node)))
        return c.b.add1(op, [y], axes=[_axis(d, _rank(x)) for d in dims], keepdims=int(bool(keep)))

    return fn


_EMITTERS["aten.mean.dim"] = _reduce("ReduceMean")
_EMITTERS["aten.sum.dim_IntList"] = _reduce("ReduceSum")
_EMITTERS["aten.amax.default"] = _reduce("ReduceMax")


@_emit("aten.std.correction")
def _std(c, node):
    """sqrt(sum((x - mean)^2) / (n - correction)) over the dims."""
    x, dims, correction, keep = _args(node)
    r = _rank(x)
    dims = list(range(r)) if not dims else [_axis(d, r) for d in dims]
    n = int(np.prod([_meta(x).shape[d] for d in dims]))
    corr = 1 if correction is None else correction
    dt = _out_dtype(node)
    xn = c.name(x)
    d = c.b.add1("Sub", [xn, c.b.add1("ReduceMean", [xn], axes=dims, keepdims=1)])
    ss = c.b.add1("ReduceSum", [c.b.add1("Mul", [d, d])], axes=dims, keepdims=int(bool(keep)))
    return c.b.add1("Sqrt", [c.b.add1("Div", [ss, c.name(_Const(float(n - corr)), dt)])])


@_emit("aten.linalg_vector_norm.default")
def _norm(c, node):
    x, order, dims, keep = _args(node)[:4]
    if order != 2:
        raise NotImplementedError(f"ONNX export: a vector norm of order {order}")
    dims = list(range(_rank(x))) if not dims else [dims] if isinstance(dims, int) else dims
    return c.b.add1("ReduceL2", [c.name(x)], axes=[_axis(d, _rank(x)) for d in dims], keepdims=int(bool(keep)))


@_emit("aten.softmax.int")
def _softmax(c, node):
    x = node.args[0]
    r = _rank(x)
    d = _axis(node.args[1], r)
    op = "Softmax"
    y = c.name(x)
    if _meta(x).dtype != _out_dtype(node):
        y = c.b.add1("Cast", [y], to=_onnx_dtype(_out_dtype(node)))
    if d == r - 1:
        return c.b.add1(op, [y], axis=d)
    perm = [i for i in range(r) if i != d] + [d]  # opset 12's Softmax flattens from its axis on
    inv = [perm.index(i) for i in range(r)]
    return c.b.transpose(c.b.add1(op, [c.b.transpose(y, perm)], axis=r - 1), inv)


# -- layers -----------------------------------------------------------------------


def _pair(v, n=2):
    v = list(v) if isinstance(v, (list, tuple)) else [v]
    return v * n if len(v) == 1 else v


@_emit("aten.conv2d.default", "aten.conv1d.default")
def _conv(c, node):
    x, w, bias, stride, padding, dilation, groups = _args(node)
    n = _rank(x) - 2
    if isinstance(padding, str):
        raise NotImplementedError(f"ONNX export: conv padding {padding!r}")
    ins = [c.name(x), c.name(w)] + ([c.name(bias)] if bias is not None else [])
    pads = _pair(padding, n)
    return c.b.add1("Conv", ins, strides=_pair(stride, n), pads=pads + pads, dilations=_pair(dilation, n),
                    group=int(groups), kernel_shape=list(_meta(w).shape[2:]))


@_emit("aten.conv_transpose2d.input")
def _conv_transpose2d(c, node):
    x, w, bias, stride, padding, output_padding, groups, dilation = _args(node)
    ins = [c.name(x), c.name(w)] + ([c.name(bias)] if bias is not None else [])
    pads = _pair(padding)
    return c.b.add1("ConvTranspose", ins, strides=_pair(stride), pads=pads + pads, dilations=_pair(dilation),
                    group=int(groups), output_padding=_pair(output_padding), kernel_shape=list(_meta(w).shape[2:]))


@_emit("aten.max_pool2d.default", "aten.avg_pool2d.default")
def _pool(c, node):
    a = _args(node)
    x, kernel, stride, padding = a[:4]
    kernel = _pair(kernel)
    stride = _pair(stride) if stride else kernel
    pads = _pair(padding)
    if str(node.target) == "aten.max_pool2d.default":
        dilation, ceil = a[4:6]
        if _pair(dilation) != [1, 1]:
            raise NotImplementedError("ONNX export: dilated max pooling")
        return c.b.add1("MaxPool", [c.name(x)], kernel_shape=kernel, strides=stride, pads=pads + pads,
                        ceil_mode=int(bool(ceil)))
    ceil, count_pad, divisor = a[4:7]
    if divisor is not None:
        raise NotImplementedError("ONNX export: avg_pool2d with a divisor_override")
    return c.b.add1("AveragePool", [c.name(x)], kernel_shape=kernel, strides=stride, pads=pads + pads,
                    ceil_mode=int(bool(ceil)), count_include_pad=int(bool(count_pad)))


@_emit("aten.adaptive_max_pool2d.default")
def _adaptive_max_pool(c, node):
    """Each output cell the max over its window [floor(i H / h), ceil((i + 1) H / h)) (a Slice and a ReduceMax
    a cell: ONNX has no adaptive pooling); the indices output is not given."""
    x, (oh, ow) = _args(node)[:2]
    H, W = _meta(x).shape[2:]
    rows = []
    for i in range(oh):
        cells = []
        for j in range(ow):
            lo = [i * H // oh, j * W // ow]
            hi = [-(-(i + 1) * H // oh), -(-(j + 1) * W // ow)]
            cell = c.b.add1("Slice", [c.name(x), c.b.i64(lo), c.b.i64(hi), c.b.i64([2, 3])])
            cells.append(c.b.add1("ReduceMax", [cell], axes=[2, 3], keepdims=1))
        rows.append(c.b.add1("Concat", cells, axis=3))
    return [c.b.add1("Concat", rows, axis=2), None]


def _resize(c, node, **attrs):
    x = node.args[0]
    scales = [float(o) / float(i) for o, i in zip(_meta(node).shape, _meta(x).shape)]
    return c.b.add1("Resize", [c.name(x), c.b.const(np.zeros(0, np.float32), "roi"),
                               c.b.const(np.asarray(scales, np.float32), "scales")], **attrs)


@_emit("aten.upsample_nearest2d.vec")
def _upsample_nearest(c, node):
    return _resize(c, node, mode="nearest", coordinate_transformation_mode="asymmetric", nearest_mode="floor")


@_emit("aten._upsample_nearest_exact2d.vec")
def _upsample_nearest_exact(c, node):
    """src = floor((dst + 0.5) / scale): half-pixel centres rounded half up."""
    return _resize(c, node, mode="nearest", coordinate_transformation_mode="half_pixel",
                   nearest_mode="round_prefer_ceil")


@_emit("aten.upsample_bilinear2d.vec")
def _upsample_bilinear(c, node):
    align = _args(node)[2]
    return _resize(c, node, mode="linear",
                   coordinate_transformation_mode="align_corners" if align else "pytorch_half_pixel")


@_emit("aten.pixel_shuffle.default")
def _pixel_shuffle(c, node):
    return c.b.add1("DepthToSpace", [c.name(node.args[0])], blocksize=int(node.args[1]), mode="CRD")


@_emit("aten.roll.default")
def _roll(c, node):
    x, shifts, dims = _args(node)
    y = c.name(x)
    for shift, d in zip(shifts, dims):
        d = _axis(d, _rank(x))
        n = _meta(x).shape[d]
        k = shift % n
        if k:  # the last k entries first
            tail = c.b.add1("Slice", [y, c.b.i64([n - k]), c.b.i64([n]), c.b.i64([d])])
            head = c.b.add1("Slice", [y, c.b.i64([0]), c.b.i64([n - k]), c.b.i64([d])])
            y = c.b.add1("Concat", [tail, head], axis=d)
    return y


@_emit("aten.matmul.default")
def _matmul(c, node):
    """MatMul; a 1-D operand (the DFL bins) as a matrix of one column or row, since OpenCV's MatMul wants
    both operands of rank 2 or more, and the product reshaped to torch's."""
    a, b = node.args[:2]
    names = [c.name(a), c.name(b)]
    if _rank(a) == 1:
        names[0] = c.b.add1("Reshape", [names[0], c.b.i64([1, _meta(a).shape[0]])])
    if _rank(b) == 1:
        names[1] = c.b.add1("Reshape", [names[1], c.b.i64([_meta(b).shape[0], 1])])
    y = c.b.add1("MatMul", names)
    return y if _rank(a) > 1 and _rank(b) > 1 else c.b.add1("Reshape", [y, c.b.i64(_shape(node))])


@_emit("aten.scaled_dot_product_attention.default")
def _sdpa(c, node):
    """softmax(q k^T * scale + mask) v, the mask boolean (False: -inf) or additive."""
    q, k, v, mask, dropout, causal, scale = _args(node)[:7]
    if causal or dropout:
        raise NotImplementedError("ONNX export: causal or dropout attention")
    dt = _out_dtype(node)
    r = _rank(k)
    kt = c.b.transpose(c.name(k), list(range(r - 2)) + [r - 1, r - 2])
    scores = c.b.add1("Mul", [c.b.add1("MatMul", [c.name(q), kt]),
                              c.name(_Const(scale or 1.0 / math.sqrt(_meta(q).shape[-1])), dt)])
    if mask is not None:
        if _meta(mask).dtype == torch.bool:
            scores = c.b.add1("Where", [c.name(mask), scores, c.name(_Const(float("-inf")), dt)])
        else:
            scores = c.b.add1("Add", [scores, c.name(mask)])
    return c.b.add1("MatMul", [c.b.add1("Softmax", [scores], axis=_rank(node) - 1), c.name(v)])


@_emit("aten.linear.default")
def _linear(c, node):
    x, w, bias = _args(node)
    wt = c.b.transpose(c.name(w), [1, 0])
    y = c.b.add1("MatMul", [c.name(x), wt])
    return c.b.add1("Add", [y, c.name(bias)]) if bias is not None else y


@_emit("aten.layer_norm.default")
def _layer_norm(c, node):
    """LayerNormalization is opset 17: (x - mean) / sqrt(var + eps) * w + b over the normalised dims."""
    x, shape, w, bias, eps = _args(node)[:5]
    dt = _out_dtype(node)
    axes = list(range(_rank(x) - len(shape), _rank(x)))
    xn = c.name(x)
    mean = c.b.add1("ReduceMean", [xn], axes=axes, keepdims=1)
    d = c.b.add1("Sub", [xn, mean])
    var = c.b.add1("ReduceMean", [c.b.add1("Mul", [d, d])], axes=axes, keepdims=1)
    y = c.b.add1("Div", [d, c.b.add1("Sqrt", [c.b.add1("Add", [var, c.name(_Const(float(eps)), dt)])])])
    if w is not None:
        y = c.b.add1("Mul", [y, c.name(w)])
    if bias is not None:
        y = c.b.add1("Add", [y, c.name(bias)])
    return y


@_emit("aten.group_norm.default")
def _group_norm(c, node):
    """GroupNormalization is opset 18: the (B, G, C / G * spatial) rows normalised (biased variance), then the
    per-channel scale and bias."""
    x, groups, w, bias, eps = _args(node)[:5]
    dt = _out_dtype(node)
    shape = list(_meta(x).shape)
    rows = c.b.add1("Reshape", [c.name(x), c.b.i64([shape[0], groups, -1])])
    mean = c.b.add1("ReduceMean", [rows], axes=[2], keepdims=1)
    d = c.b.add1("Sub", [rows, mean])
    var = c.b.add1("ReduceMean", [c.b.add1("Mul", [d, d])], axes=[2], keepdims=1)
    y = c.b.add1("Div", [d, c.b.add1("Sqrt", [c.b.add1("Add", [var, c.name(_Const(float(eps)), dt)])])])
    y = c.b.add1("Reshape", [y, c.b.i64(shape)])
    per_channel = [shape[1]] + [1] * (len(shape) - 2)
    if w is not None:
        y = c.b.add1("Mul", [y, c.b.add1("Reshape", [c.name(w), c.b.i64(per_channel)])])
    if bias is not None:
        y = c.b.add1("Add", [y, c.b.add1("Reshape", [c.name(bias), c.b.i64(per_channel)])])
    return y


@_emit("aten.batch_norm.default")
def _batch_norm(c, node):
    x, w, bias, mean, var, training, _, eps, _ = _args(node)
    if training:
        raise NotImplementedError("ONNX export: a BatchNorm in training mode")
    n = _meta(x).shape[1]
    ones = _Const(torch.ones(n)) if w is None else c.value(w)
    zeros = _Const(torch.zeros(n)) if bias is None else c.value(bias)
    return c.b.add1("BatchNormalization", [c.name(x), c.name(ones), c.name(zeros), c.name(mean), c.name(var)],
                    epsilon=float(eps))


@_emit("aten.einsum.default")
def _einsum(c, node):
    equation, tensors = _args(node)[:2]
    return c.b.add1("Einsum", [c.name(t) for t in tensors], equation=str(equation).replace(" ", ""))


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------


def export_onnx(module: torch.nn.Module, example: torch.Tensor, path: str,
                output_names: Optional[Sequence[str]] = None, graph_name: str = "lpc_yolo_tpu_torch") -> int:
    """Export `module(example)` (one f32 input, a tensor or a tuple of tensors out) as ONNX to `path`, with the
    input named "images" and the outputs `output_names`; returns the graph's node count."""
    fx_config = getattr(torch.fx, "config", None)
    quiet = getattr(fx_config, "do_not_emit_stack_traces", None)
    if quiet is not None:  # the converter reads no node's stack trace: not collecting them saves ~15% of a trace
        fx_config.do_not_emit_stack_traces = True
    try:
        with torch.no_grad():
            ep = torch.export.export(module, (example,))
    finally:
        if quiet is not None:
            fx_config.do_not_emit_stack_traces = quiet
    b = _Builder()
    conv = _Converter(b)
    conv.run(ep)
    out_node = next(n for n in ep.graph.nodes if n.op == "output")
    outs = list(out_node.args[0])
    output_names = list(output_names or [f"output_{i}" for i in range(len(outs))])
    if len(output_names) != len(outs):
        raise ValueError(f"expected {len(outs)} output names, got {len(output_names)}")
    final = []
    for name, node in zip(output_names, outs):
        v = conv.value(node)
        src = conv.name(v) if not isinstance(v, str) else v
        b.nodes.append(("Identity", [src], [name], {}))
        final.append(name)
    nodes = b.used(final)
    read = {i for _, ins, _, _ in nodes for i in ins}
    inits = [_tensor_proto(k, v) for k, v in b.initializers.items() if k in read]
    protos = [_node_proto(op, ins, outs_, f"n{i}_{op}", attrs) for i, (op, ins, outs_, attrs) in enumerate(nodes)]
    in_info = [_value_info("images", example.shape, example.dtype)]
    out_info = [_value_info(name, _meta(node).shape, _meta(node).dtype) for name, node in zip(output_names, outs)]
    with open(path, "wb") as f:
        f.write(_model_proto(protos, inits, in_info, out_info, graph_name))
    return len(protos)
