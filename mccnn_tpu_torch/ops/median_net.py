"""The 5x5 median kernel's fast network: the rank-12 selection for a
block of R x C adjacent outputs, written out as min/max operations that
share sorted columns (``MEDIAN5_FAST_NET`` in csrc/refine.cu).

    python -m mccnn_tpu_torch.ops.median_net   # prints the macros

The construction is separable (A. Adams, "Fast median filters using
separable sorting networks", ACM TOG 40(4), 2021): each output's window
is the union of sorted lists, and the lists that several outputs share
are built once. Down each column of the block's (R + 4) x (C + 4)
inputs, the rows that a set of output rows all hold are sorted once and
merged with the rows each subset adds, splitting the output rows in
halves; then, along each output row, the column lists are merged the
same way over the output columns. Every merge is Batcher's odd-even
merge of two sorted lists (padded with +inf to a power of two, the
padding folded away), cut to the ranks that the merges above it can
still use: rank 12 of a window's 25 is the only one read at the top,
and a merge of lists of a and b values needs ranks lo..hi only from
ranks max(0, lo - b)..min(hi, a - 1) of the first and
max(0, lo - a)..min(hi, b - 1) of the second. Operations whose result
no output reads are dropped.

The result selects rank 12 of each window for every input only where
the window's values are totally ordered with equal values of equal bits
(no NaN, no -0.0): the kernel's fast path. The CPU tests check it on
every 0-1 window (the 0-1 principle) and on tied values.
"""

from __future__ import annotations

R, C = 2, 4          # a thread's outputs: 2 rows x 4 columns
_INF = ("inf",)


class _Graph:
    """Hash-consed min/max nodes over input keys ("in", index)."""

    def __init__(self):
        self.nodes: dict = {}

    def _node(self, op, a, b):
        a, b = sorted((a, b), key=repr)
        return self.nodes.setdefault((op, a, b), (op, a, b))

    def min(self, a, b):
        if a == _INF:
            return b
        if b == _INF or a == b:
            return a
        return self._node("min", a, b)

    def max(self, a, b):
        if _INF in (a, b):
            return _INF
        if a == b:
            return a
        return self._node("max", a, b)


def _odd_even(g: _Graph, a: list, b: list) -> list:
    """Batcher's merge of two sorted lists of one power-of-two length."""
    if len(a) == 1:
        return [g.min(a[0], b[0]), g.max(a[0], b[0])]
    e, o = _odd_even(g, a[0::2], b[0::2]), _odd_even(g, a[1::2], b[1::2])
    out = [e[0]]
    for i in range(len(a) - 1):
        out += [g.min(o[i], e[i + 1]), g.max(o[i], e[i + 1])]
    return out + [o[-1]]


def _merge(g: _Graph, a: list, b: list) -> list:
    n = 1
    while n < max(len(a), len(b)):
        n *= 2
    pad = lambda v: list(v) + [_INF] * (n - len(v))  # noqa: E731
    return _odd_even(g, pad(a), pad(b))[:len(a) + len(b)]


class _List:
    """A sorted list: one input, or the merge of two lists; ``lo``..``hi``
    the ranks that some reader needs."""

    def __init__(self, size, kids=(), leaf=None):
        self.size, self.kids, self.leaf = size, kids, leaf
        self.lo = self.hi = self.ranks = None


def _merged(memo: dict, a: _List, b: _List) -> _List:
    key = (id(a), id(b))
    if key not in memo:
        memo[key] = _List(a.size + b.size, (a, b))
    return memo[key]


def _sorted(memo: dict, lists: list) -> _List:
    if len(lists) == 1:
        return lists[0]
    h = len(lists) // 2
    return _merged(memo, _sorted(memo, lists[:h]), _sorted(memo, lists[h:]))


def _shared(memo: dict, n: int, item) -> list:
    """The lists of outputs 0..n-1, output i the union of ``item(p)`` for
    p in i..i+4: the positions every output of a range holds are merged
    once, then each half of the range adds its own."""
    out = [None] * n

    def visit(lo, hi, above, held):
        core = range(hi - 1, lo + 5)
        extra = [item(p) for p in core if p not in held]
        lst = above
        if extra:
            add = _sorted(memo, extra)
            lst = add if above is None else _merged(memo, above, add)
        if hi - lo == 1:
            out[lo] = lst
        else:
            m = (lo + hi) // 2
            visit(lo, m, lst, set(core))
            visit(m, hi, lst, set(core))

    visit(0, n, None, set())
    return out


def _need(lst: _List, lo: int, hi: int) -> None:
    if lst.lo is None:
        lst.lo, lst.hi = lo, hi
    else:
        lst.lo, lst.hi = min(lst.lo, lo), max(lst.hi, hi)


def _ranks(g: _Graph, lst: _List) -> dict:
    """{rank: node} of ``lst`` over its needed ranks."""
    if lst.ranks is None:
        if not lst.kids:
            lst.ranks = {0: lst.leaf}
        else:
            (a, b), lo, hi = lst.kids, lst.lo, lst.hi
            ta, tb = max(0, lo - b.size), max(0, lo - a.size)
            ra, rb = _ranks(g, a), _ranks(g, b)
            m = _merge(g, [ra[i] for i in range(ta, min(hi, a.size - 1) + 1)],
                       [rb[i] for i in range(tb, min(hi, b.size - 1) + 1)])
            lst.ranks = {r: m[r - ta - tb] for r in range(lo, hi + 1)}
    return lst.ranks


def program(rows: int = R, cols: int = C):
    """(ops, outputs): ops [(op, dst, a, b)], "min" or "max" on value
    numbers in order of evaluation, the inputs first (row r, column c of
    the (rows + 4) x (cols + 4) window union is number r (cols + 4) + c);
    outputs [(k, src)]: output k (row k // cols, column k % cols) is
    value src, rank 12 of its 5 x 5 window."""
    g, memo = _Graph(), {}
    width = cols + 4
    leaves = {}

    def leaf(r, c):
        if (r, c) not in leaves:
            leaves[r, c] = _List(1, leaf=("in", r * width + c))
        return leaves[r, c]

    column = [_shared(memo, rows, lambda p, c=c: leaf(p, c))
              for c in range(width)]
    tops = [t for i in range(rows)
            for t in _shared(memo, cols, lambda p, i=i: column[p][i])]
    every = {}

    def collect(lst):
        if id(lst) not in every:
            every[id(lst)] = lst
            for k in lst.kids:
                collect(k)

    for t in tops:
        collect(t)
        _need(t, 12, 12)
    for lst in sorted(every.values(), key=lambda v: -v.size):
        if lst.kids:
            a, b = lst.kids
            _need(a, max(0, lst.lo - b.size), min(lst.hi, a.size - 1))
            _need(b, max(0, lst.lo - a.size), min(lst.hi, b.size - 1))
    picks = [_ranks(g, t)[12] for t in tops]
    number = {("in", i): i for i in range((rows + 4) * width)}
    ops = []

    def emit(node):
        if node in number:
            return number[node]
        a, b = sorted((emit(node[1]), emit(node[2])))
        number[node] = len(number)
        ops.append((node[0], number[node], a, b))
        return number[node]

    outputs = [(k, emit(p)) for k, p in enumerate(picks)]
    return ops, outputs


def _define(head: str, items: list, width: int = 78) -> str:
    lines, line = [], " "
    for it in items:
        if len(line) + len(it) + 3 > width:
            lines.append(line)
            line = " "
        line += " " + it
    return " \\\n".join([f"#define {head}"] + lines + [line])


def macros(rows: int = R, cols: int = C) -> str:
    """The two macros of csrc/refine.cu: ``MEDIAN5_FAST_IN(I)``, I(n, r,
    c) for input n at row r, column c of the window union, and
    ``MEDIAN5_FAST_NET(N, X, O)``, N(d, a, b) a min and X(d, a, b) a max
    of values a and b into value d, O(k, s) output k."""
    ops, outputs = program(rows, cols)
    ins = [f"I({r * (cols + 4) + c}, {r}, {c})" for r in range(rows + 4)
           for c in range(cols + 4)]
    net = ([f"{'N' if op == 'min' else 'X'}({d}, {a}, {b})"
            for op, d, a, b in ops] + [f"O({k}, {s})" for k, s in outputs])
    return (_define("MEDIAN5_FAST_IN(I)", ins) + "\n"
            + _define("MEDIAN5_FAST_NET(N, X, O)", net))


if __name__ == "__main__":
    ops, _ = program()
    print(f"// {len(ops)} min/max for {R * C} outputs: "
          f"{len(ops) / (R * C)} a pixel")
    print(macros())
