"""GL5 — CUDA launch bounds, the port's counterpart of Pallas bounds.

The reference's GL5 holds a ``pl.pallas_call``'s BlockSpec tiles against
its shapes and grid. The port's kernels are CUDA C++ under ``csrc/``, and
the same arithmetic lives in their launches: a grid that does not cover
the shape in the kernel's own tiles leaves rows unwritten or steps past
the buffer, and a block that is not the kernel's ``__launch_bounds__``
either fails to launch or runs a kernel compiled for other registers.
This checker reads ``csrc/*.cu`` (and the headers they include) as text,
resolves ``constexpr`` integer arithmetic, single-``return`` helper
functions and template instantiations, and checks every ``<<<…>>>``
launch where the numbers are static. Anything dynamic stays quiet, as in
the reference: the rule errs unreported, not wrong.

- **GL501** — a grid axis along which the kernel steps its
  ``blockIdx`` by a tile constant (``q0 = blockIdx.y * TC_BM``) is not
  the ceiling division of a shape by that same tile: a floor division
  drops the tail tile, a mismatched tile covers too much or too little,
  and a ``(S + T - 1) / U`` with ``T != U`` is no ceiling division.
- **GL502** — the block size of a launch differs from the kernel's
  ``__launch_bounds__``, or a launch's shared memory (per template
  instantiation) exceeds Hopper's opt-in limit of 232,448 bytes (227 KB)
  a block.

``launch_model(csrc_dir)`` returns the resolved launches (kernel,
instantiation, threads, shared-memory formula) for ``chip_smoke.py``,
which holds them against ptxas and against what the card ran.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Iterable

from pygrid_tpu_torch.analysis.core import Checker, Finding

#: Hopper's largest dynamic shared memory a block may opt in to
SMEM_LIMIT = 232448

_SIZEOF = {
    "char": 1, "unsigned char": 1, "int8_t": 1, "uint8_t": 1,
    "short": 2, "__nv_bfloat16": 2, "__half": 2, "half": 2,
    "int": 4, "unsigned": 4, "unsigned int": 4, "float": 4,
    "int32_t": 4, "uint32_t": 4,
    "long long": 8, "unsigned long long": 8, "double": 8, "size_t": 8,
    "int64_t": 8, "uint64_t": 8, "u64": 8, "uint4": 16, "float4": 16,
}
_CAST = re.compile(
    r"\(\s*(?:const\s+)?(?:unsigned\s+|signed\s+)?"
    r"(?:long\s+long|long|int|short|char|size_t|unsigned|int64_t|int32_t)"
    r"\s*\)"
)
_SIZEOF_RE = re.compile(r"sizeof\s*\(\s*([\w:\s]+?)\s*\)")
_TOKEN = re.compile(
    r"\s*(?:(\d+)[uUlL]*|([A-Za-z_][\w:]*(?:\.[xyz])?)|"
    r"(<=|>=|==|!=|&&|\|\||<<|>>|[-+*/%()?:<>!,]))"
)


# ── C integer expressions ───────────────────────────────────────────────


class _Node:
    __slots__ = ("op", "args", "name", "value")

    def __init__(self, op, args=(), name=None, value=None):
        self.op, self.args, self.name, self.value = op, list(args), name, value


def _tokens(text: str) -> list[str] | None:
    text = _CAST.sub(" ", text)
    text = _SIZEOF_RE.sub(
        lambda m: str(_SIZEOF.get(" ".join(m.group(1).split()).split("::")[-1], "!")),
        text,
    )
    out, pos = [], 0
    text = text.strip()
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if m is None or m.end() == pos:
            return None  # something this reader does not model
        out.append(m.group(1) or m.group(2) or m.group(3))
        pos = m.end()
        while pos < len(text) and text[pos].isspace():
            pos += 1
    return out


class _Parser:
    """Precedence-climbing parser for the integer arithmetic launches
    use: ``?:``, ``|| &&``, comparisons, ``+ - * / %``, unary ``- !``,
    calls and parentheses. Names keep only their last ``::`` part."""

    _BIN = [("||",), ("&&",), ("==", "!="), ("<", ">", "<=", ">="),
            ("<<", ">>"), ("+", "-"), ("*", "/", "%")]

    def __init__(self, toks: list[str]) -> None:
        self.t, self.i = toks, 0

    def _peek(self) -> str | None:
        return self.t[self.i] if self.i < len(self.t) else None

    def _take(self, want: str | None = None) -> str:
        tok = self._peek()
        if tok is None or (want is not None and tok != want):
            raise ValueError(f"expected {want!r}, got {tok!r}")
        self.i += 1
        return tok

    def parse(self) -> _Node:
        node = self._ternary()
        if self._peek() is not None:
            raise ValueError(f"trailing {self._peek()!r}")
        return node

    def _ternary(self) -> _Node:
        cond = self._binary(0)
        if self._peek() == "?":
            self._take()
            a = self._ternary()
            self._take(":")
            b = self._ternary()
            return _Node("?", (cond, a, b))
        return cond

    def _binary(self, level: int) -> _Node:
        if level == len(self._BIN):
            return self._unary()
        node = self._binary(level + 1)
        while self._peek() in self._BIN[level]:
            op = self._take()
            node = _Node(op, (node, self._binary(level + 1)))
        return node

    def _unary(self) -> _Node:
        if self._peek() in ("-", "!", "+"):
            op = self._take()
            return _Node("u" + op, (self._unary(),))
        return self._primary()

    def _primary(self) -> _Node:
        tok = self._take()
        if tok == "(":
            node = self._ternary()
            self._take(")")
            return node
        if tok[0].isdigit():
            return _Node("num", value=int(tok))
        if tok == "!":
            raise ValueError("unknown sizeof")
        name = tok.split("::")[-1]
        if self._peek() == "(":
            self._take()
            args = []
            if self._peek() != ")":
                args.append(self._ternary())
                while self._peek() == ",":
                    self._take()
                    args.append(self._ternary())
            self._take(")")
            return _Node("call", args, name=name)
        return _Node("name", name=name)


def parse_expr(text: str) -> _Node | None:
    toks = _tokens(text)
    if not toks:
        return None
    try:
        return _Parser(toks).parse()
    except (ValueError, IndexError):
        return None


def _div(a: int, b: int) -> int:
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


_OPS = {
    "+": lambda a, b: a + b, "-": lambda a, b: a - b,
    "*": lambda a, b: a * b, "/": _div,
    "%": lambda a, b: a - _div(a, b) * b,
    "<<": lambda a, b: a << b, ">>": lambda a, b: a >> b,
    "<": lambda a, b: int(a < b), ">": lambda a, b: int(a > b),
    "<=": lambda a, b: int(a <= b), ">=": lambda a, b: int(a >= b),
    "==": lambda a, b: int(a == b), "!=": lambda a, b: int(a != b),
    "&&": lambda a, b: int(bool(a and b)), "||": lambda a, b: int(bool(a or b)),
}


class Env:
    """Names (constants, template arguments, runtime values) and helper
    functions an expression may use. Values are ints or unparsed
    expression text (evaluated on first use, cycles stay dynamic)."""

    def __init__(self, values=None, funcs=None, parent: "Env | None" = None):
        self.values: dict[str, int | str] = dict(values or {})
        self.funcs: dict[str, tuple[list[str], str]] = dict(funcs or {})
        self.parent = parent
        self._busy: set[str] = set()

    def child(self, values=None) -> "Env":
        return Env(values, parent=self)

    def lookup(self, name: str) -> int | str | None:
        env: Env | None = self
        while env is not None:
            if name in env.values:
                return env.values[name]
            env = env.parent
        return None

    def func(self, name: str) -> tuple[list[str], str] | None:
        env: Env | None = self
        while env is not None:
            if name in env.funcs:
                return env.funcs[name]
            env = env.parent
        return None

    def value(self, name: str) -> int | None:
        v = self.lookup(name)
        if isinstance(v, int) or v is None:
            return v
        if name in self._busy:
            return None
        self._busy.add(name)
        try:
            return self.eval(v)
        finally:
            self._busy.discard(name)

    def eval(self, expr: "str | _Node | None") -> int | None:
        node = parse_expr(expr) if isinstance(expr, str) else expr
        return None if node is None else self._eval(node)

    def _eval(self, n: _Node) -> int | None:
        if n.op == "num":
            return n.value
        if n.op == "name":
            return self.value(n.name)
        if n.op == "call":
            return self._call(n)
        if n.op == "?":
            c = self._eval(n.args[0])
            return None if c is None else self._eval(n.args[1 if c else 2])
        vals = [self._eval(a) for a in n.args]
        if any(v is None for v in vals):
            return None
        if n.op == "u-":
            return -vals[0]
        if n.op == "u+":
            return vals[0]
        if n.op == "u!":
            return int(not vals[0])
        if n.op in ("/", "%") and vals[1] == 0:
            return None
        return _OPS[n.op](*vals)

    def _call(self, n: _Node) -> int | None:
        fn = self.func(n.name)
        if fn is None or len(fn[0]) != len(n.args):
            return None
        args = [self._eval(a) for a in n.args]
        if any(a is None for a in args):
            return None
        return self.child(dict(zip(fn[0], args))).eval(fn[1])


# ── CUDA source model ──────────────────────────────────────────────────


def _strip_comments(text: str) -> str:
    """Comments and string literals blanked, newlines kept (line numbers
    stay true)."""

    def blank(m: re.Match) -> str:
        return re.sub(r"[^\n]", " ", m.group(0))

    return re.sub(
        r"//[^\n]*|/\*.*?\*/|\"(?:\\.|[^\"\\\n])*\"|'(?:\\.|[^'\\\n])'",
        blank, text, flags=re.S,
    )


def _split_top(text: str, sep: str = ",") -> list[str]:
    out, depth, cur = [], 0, []
    for ch in text:
        depth += (ch in "([{") - (ch in ")]}")
        if ch == sep and depth == 0:
            out.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    if "".join(cur).strip():
        out.append("".join(cur).strip())
    return out


_CONSTEXPR = re.compile(
    r"\b(?:static\s+)?constexpr\s+(?:unsigned\s+|signed\s+)?"
    r"(?:long\s+long|int|size_t|long|unsigned|int64_t|int32_t|uint32_t)\s+"
    r"(\w+)\s*=\s*([^;]+);"
)
_LOCAL_DEF = re.compile(
    r"\b(?:const\s+|constexpr\s+)(?:unsigned\s+|signed\s+)?"
    r"(?:long\s+long|int|size_t|long|unsigned|int64_t|int32_t|uint32_t)\s+"
    r"(\w+)\s*=\s*([^;]+);"
)
_DIM3 = re.compile(r"\bdim3\s+(\w+)\s*\(([^;]*)\)\s*;")
_INDEX_DEF = re.compile(r"\b(?:const\s+)?int\s+(\w+)\s*=\s*([^;]+);")
_LAUNCH = re.compile(r"([\w:]+)\s*(?:<([^<>;]*)>)?\s*<<<(.*?)>>>", re.S)
_INCLUDE = re.compile(r'#\s*include\s*"([^"]+)"')


def _decls(m: re.Match) -> list[tuple[str, str]]:
    """``(name, value text)`` of a declaration match, commas included:
    ``constexpr int BQ = TC_DQ_BQ, BK = TC_DQ_BK;`` gives two."""
    parts = _split_top(m.group(2))
    out = [(m.group(1), parts[0])]
    for part in parts[1:]:
        name, eq, value = part.partition("=")
        if eq and re.fullmatch(r"\s*\w+\s*", name):
            out.append((name.strip(), value.strip()))
    return out


@dataclass
class Function:
    name: str
    path: str
    line: int
    header: str
    body: str
    body_line: int  # line of the body's first character
    span: tuple[int, int]  # offsets of the body in its file's text
    template: list[str] = field(default_factory=list)
    is_kernel: bool = False
    bounds: str | None = None  # the first __launch_bounds__ argument


@dataclass
class Launch:
    """One ``<<<…>>>`` launch at one template instantiation."""

    kernel: str
    targs: tuple[int, ...]  # the kernel's template arguments
    path: str
    line: int
    launcher: str
    grid: list[str]
    block_expr: str
    smem_expr: str | None
    env: Env
    kernel_fn: Function | None

    @property
    def block(self) -> int | None:
        return self.env.eval(self.block_expr)

    @property
    def threads(self) -> int | None:
        """The kernel's ``__launch_bounds__`` threads."""
        if self.kernel_fn is None or self.kernel_fn.bounds is None:
            return None
        return self.kernel_env().eval(self.kernel_fn.bounds)

    def kernel_env(self) -> Env:
        names = self.kernel_fn.template if self.kernel_fn else []
        return self.env.child(dict(zip(names, self.targs)))

    def smem(self, **runtime: int) -> int | None:
        """Dynamic shared memory of this launch; runtime values (``D``)
        may be bound for a formula that depends on them."""
        if self.smem_expr is None:
            return 0
        return self.env.child(runtime).eval(self.smem_expr)

    @property
    def name(self) -> str:
        return self.kernel + (
            "<" + ",".join(map(str, self.targs)) + ">" if self.targs else ""
        )


def _functions(path: str, text: str) -> list[Function]:
    """Function definitions at namespace level (kernels included)."""
    out: list[Function] = []
    depth_kinds: list[str] = []  # "ns" or "fn"/"other" per open brace
    last = 0  # end of the previous namespace-level statement
    i = 0
    while i < len(text):
        ch = text[i]
        if ch == "{":
            if all(k == "ns" for k in depth_kinds):
                header = text[last:i].strip()
                # string literals are blanked: ``extern "C" {`` reads
                # as a bare ``extern``
                if re.match(r"(?:inline\s+)?namespace\b", header) or re.fullmatch(
                    r"extern\s*", header
                ):
                    depth_kinds.append("ns")
                    last = i + 1
                    i += 1
                    continue
                # the body: match braces
                depth, j = 1, i + 1
                while j < len(text) and depth:
                    depth += {"{": 1, "}": -1}.get(text[j], 0)
                    j += 1
                if "(" in header and not re.match(r"(struct|class|union|enum)\b", header):
                    out.append(_function(path, text, header, last, i, j))
                last = j
                i = j
                continue
            depth_kinds.append("other")
        elif ch == "}":
            if depth_kinds:
                depth_kinds.pop()
            last = i + 1
        elif ch == ";" and all(k == "ns" for k in depth_kinds):
            last = i + 1
        i += 1
    return out


def _function(path, text, header, start, open_at, close_at) -> Function:
    lead = len(text[start:open_at]) - len(text[start:open_at].lstrip())
    head_line = text.count("\n", 0, start + lead) + 1
    template: list[str] = []
    m = re.match(r"template\s*<([^>]*)>\s*", header)
    if m:
        for part in _split_top(m.group(1)):
            words = part.replace("=", " = ").split()
            if "=" in words:
                words = words[: words.index("=")]
            template.append(words[-1])
        header = header[m.end():]
    bounds = None
    lb = re.search(r"__launch_bounds__\s*\(", header)
    if lb:
        depth, j = 1, lb.end()
        while depth and j < len(header):
            depth += {"(": 1, ")": -1}.get(header[j], 0)
            j += 1
        bounds = _split_top(header[lb.end() : j - 1])[0]
        header = header[: lb.start()] + header[j:]
    name_m = re.search(r"([A-Za-z_]\w*)\s*\(", header)
    return Function(
        name=name_m.group(1) if name_m else "?",
        path=path,
        line=head_line,
        header=header,
        body=text[open_at + 1 : close_at - 1],
        body_line=text.count("\n", 0, open_at + 1) + 1,
        span=(open_at + 1, close_at - 1),
        template=template,
        is_kernel="__global__" in header,
        bounds=bounds,
    )


class CudaSource:
    """One ``.cu`` file with the headers it includes: constants, helper
    functions, kernels and launches."""

    def __init__(self, path: str, rel: str) -> None:
        self.path, self.rel = path, rel
        self.env = Env()
        self.functions: list[Function] = []
        self._load(path, rel, set())
        self.kernels = {f.name: f for f in self.functions if f.is_kernel}

    def _load(self, path: str, rel: str, seen: set[str]) -> None:
        if path in seen or not os.path.isfile(path):
            return
        seen.add(path)
        with open(path, encoding="utf-8") as fh:
            raw = fh.read()
        text = _strip_comments(raw)
        # preprocessor lines blanked too (their names never feed a launch)
        text = re.sub(r"(?m)^[ \t]*#[^\n]*", lambda m: " " * len(m.group(0)), text)
        for inc in _INCLUDE.findall(re.sub(r"//[^\n]*", "", raw)):
            self._load(
                os.path.join(os.path.dirname(path), inc),
                os.path.join(os.path.dirname(rel), inc).replace(os.sep, "/"),
                seen,
            )
        fns = _functions(rel, text)
        for m in _CONSTEXPR.finditer(text):
            if not any(a <= m.start() < b for a, b in (f.span for f in fns)):
                for name, value in _decls(m):
                    self.env.values.setdefault(name, value)
        for f in fns:
            ret = re.fullmatch(r"\s*return\s+([^;]+);\s*", f.body)
            params = [p.split()[-1] for p in _split_top(
                f.header[f.header.find("(") + 1 : f.header.rfind(")")]
            ) if p.strip()]
            if ret and not f.is_kernel:
                self.env.funcs[f.name] = (params, ret.group(1))
        self.functions.extend(fns)

    def launches(self) -> list[Launch]:
        out: list[Launch] = []
        for fn in self.functions:
            if fn.path != self.rel or fn.is_kernel:
                continue
            for m in _LAUNCH.finditer(fn.body):
                out.extend(self._instantiate(fn, m))
        return out

    def _instantiations(self, fn: Function) -> list[tuple[int, ...]]:
        if not fn.template:
            return [()]
        found: list[tuple[int, ...]] = []
        pat = re.compile(rf"\b{re.escape(fn.name)}\s*<([^<>;]*)>\s*\(")
        for other in self.functions:
            for m in pat.finditer(other.body):
                vals = tuple(self.env.eval(a) for a in _split_top(m.group(1)))
                if all(v is not None for v in vals) and vals not in found:
                    found.append(vals)
        return found

    def _instantiate(self, fn: Function, m: re.Match) -> list[Launch]:
        kernel = m.group(1).split("::")[-1]
        args = _split_top(m.group(3))
        if len(args) < 2:
            return []
        before = fn.body[: m.start()]
        line = fn.body_line + fn.body.count("\n", 0, m.start())
        locals_: dict[str, str] = {}
        for d in _LOCAL_DEF.finditer(before):
            locals_.update(_decls(d))
        dims: dict[str, list[str]] = {
            d.group(1): _split_top(d.group(2)) for d in _DIM3.finditer(before)
        }
        grid_arg = args[0].strip()
        if grid_arg in dims:
            grid = dims[grid_arg]
        else:
            inline = re.fullmatch(r"dim3\s*\((.*)\)", grid_arg, re.S)
            grid = _split_top(inline.group(1)) if inline else [grid_arg]
        out = []
        for inst in self._instantiations(fn):
            env = self.env.child(dict(zip(fn.template, inst)))
            env = env.child(locals_)
            targs = tuple(
                env.eval(a) for a in _split_top(m.group(2) or "")
            ) if m.group(2) else ()
            if any(t is None for t in targs):
                continue
            out.append(Launch(
                kernel=kernel, targs=targs, path=self.rel, line=line,
                launcher=fn.name, grid=grid, block_expr=args[1],
                smem_expr=args[2] if len(args) > 2 else None, env=env,
                kernel_fn=self.kernels.get(kernel),
            ))
        return out


def _expand(expr: str, env: Env, depth: int = 0) -> _Node | None:
    """``expr`` parsed, with launcher locals and single-return helpers
    substituted in, so ``n_chunks(D)`` reads as ``(D + DC - 1) / DC``."""
    node = parse_expr(expr)
    if node is None or depth > 4:
        return node

    def sub(n: _Node, bind: dict[str, _Node]) -> _Node:
        if n.op == "name":
            if n.name in bind:
                return bind[n.name]
            v = env.lookup(n.name)
            if isinstance(v, str) and depth < 4:
                inner = _expand(v, env, depth + 1)
                if inner is not None and inner.op != "num":
                    return inner
            return n
        if n.op == "call":
            f = env.func(n.name)
            args = [sub(a, bind) for a in n.args]
            if f is not None and len(f[0]) == len(args):
                body = parse_expr(f[1])
                if body is not None:
                    return sub(body, dict(zip(f[0], args)))
            return _Node("call", args, name=n.name)
        return _Node(n.op, [sub(a, bind) for a in n.args], n.name, n.value)

    return sub(node, {})


def _ceil_div(node: _Node, env: Env) -> tuple[str, int | None] | None:
    """Classify a grid axis: ("ceil", T), ("floor", U), ("bad", U) for a
    ``(S + T - 1) / U`` with T != U, or None (not a division)."""
    if node.op != "/":
        return None
    num, den = node.args
    u = env.eval(den)
    if num.op == "-" and num.args[1].op == "num" and num.args[1].value == 1 and (
        num.args[0].op == "+"
    ):
        t = env.eval(num.args[0].args[1])
        return ("ceil", u) if t is not None and t == u else ("bad", u)
    if num.op == "+" and num.args[1].op == "-" and (
        num.args[1].args[1].op == "num" and num.args[1].args[1].value == 1
    ):
        t = env.eval(num.args[1].args[0])
        return ("ceil", u) if t is not None and t == u else ("bad", u)
    return ("floor", u)


def axis_tiles(kernel: Function, env: Env) -> dict[str, int]:
    """The tile a kernel steps each grid axis by: ``blockIdx.a * C`` or
    ``i * C`` for an ``int i`` that holds ``blockIdx.a`` (plain, or
    reversed as ``gridDim.a - 1 - blockIdx.a``). Axes with no such
    product, or with two different tiles, are left out."""
    body = kernel.body
    local = env.child(
        {n: v for m in _CONSTEXPR.finditer(body) for n, v in _decls(m)}
    )
    tiles: dict[str, set[int | None]] = {}
    for axis in "xyz":
        names = [f"blockIdx.{axis}"]
        for m in _INDEX_DEF.finditer(body):
            rhs = m.group(2)
            if f"blockIdx.{axis}" in rhs and not re.search(r"[*/%]", rhs):
                names.append(m.group(1))
        alt = "|".join(re.escape(n) for n in names)
        for m in re.finditer(
            rf"(?<![\w.])(?:({alt})\s*\*\s*([\w:]+)|([\w:]+)\s*\*\s*({alt}))(?![\w.])",
            body,
        ):
            c = m.group(2) or m.group(3)
            tiles.setdefault(axis, set()).add(local.eval(c))
    return {
        a: next(iter(v)) for a, v in tiles.items()
        if len(v) == 1 and None not in v
    }


def launch_model(csrc_dir: str, root: str | None = None) -> list[Launch]:
    """Every resolved launch in ``csrc_dir``'s ``.cu`` files."""
    root = root or os.path.dirname(os.path.abspath(csrc_dir))
    out: list[Launch] = []
    for name in sorted(os.listdir(csrc_dir)):
        if name.endswith(".cu"):
            path = os.path.join(csrc_dir, name)
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            out.extend(CudaSource(path, rel).launches())
    return out


class CudaBoundsChecker(Checker):
    name = "GL5"
    description = "CUDA launch grid / block / shared-memory bounds (csrc/)"
    codes = {
        "GL501": "launch grid axis is not a ceiling division of the shape "
        "by the kernel's own tile",
        "GL502": "block size differs from __launch_bounds__, or shared "
        "memory over Hopper's 227 KB a block",
    }

    def finalize(self, run) -> Iterable[Finding]:
        dirs = sorted({
            os.path.join(os.path.dirname(m.path), "csrc") for m in run.modules
        })
        findings: list[Finding] = []
        for csrc in dirs:
            if not os.path.isdir(csrc):
                continue
            for launch in launch_model(csrc, run.root):
                findings.extend(self._check(launch))
        return findings

    @staticmethod
    def _finding(launch: Launch, code: str, msg: str) -> Finding:
        return Finding(
            code=code, path=launch.path, line=launch.line, col=0,
            message=f"{launch.name} in {launch.launcher}(): {msg}",
            end_line=launch.line,
        )

    def _check(self, launch: Launch) -> list[Finding]:
        out: list[Finding] = []
        block, threads = launch.block, launch.threads
        if block is not None and threads is not None and block != threads:
            out.append(self._finding(
                launch, "GL502",
                f"launched with {block} threads a block but compiled for "
                f"__launch_bounds__({threads})",
            ))
        smem = launch.smem()
        if smem is not None and smem > SMEM_LIMIT:
            out.append(self._finding(
                launch, "GL502",
                f"{smem} bytes of shared memory a block, over Hopper's "
                f"{SMEM_LIMIT}",
            ))
        if launch.kernel_fn is None:
            return out
        tiles = axis_tiles(launch.kernel_fn, launch.kernel_env())
        for axis, expr in zip("xyz", launch.grid):
            tile = tiles.get(axis)
            node = _expand(expr, launch.env)
            if tile is None or node is None:
                continue
            kind = _ceil_div(node, launch.env)
            if kind is None:
                msg = (f"grid.{axis} = {expr.strip()} is no division, but the "
                       f"kernel steps blockIdx.{axis} by {tile}")
            elif kind[0] == "floor":
                msg = (f"grid.{axis} = {expr.strip()} rounds down: the tail "
                       f"tile of {tile} is never launched")
            elif kind[0] == "bad":
                msg = (f"grid.{axis} = {expr.strip()} is not a ceiling "
                       "division (the added tile and the divisor differ)")
            elif kind[1] != tile:
                msg = (f"grid.{axis} = {expr.strip()} divides by {kind[1]}, "
                       f"but the kernel steps blockIdx.{axis} by {tile}")
            else:
                continue
            out.append(self._finding(launch, "GL501", msg))
        return out
