"""Search-space structure as Graphviz DOT text.

Counterpart of ``hyperopt_tpu/graphviz.py``: ``dot_hyperparameters(space)``
renders the compiled space's parameter tree (nested dicts and lists,
choice branches, scope applications and the scalar parameters with their
distributions).  Text only: no graphviz binary or package (render with
``dot -Tpng``).
"""

from __future__ import annotations

from .space import (
    _T_APPLY,
    _T_CHOICE,
    _T_DICT,
    _T_LIST,
    _T_LITERAL,
    _T_PARAM,
    _T_SWITCH,
    _T_TUPLE,
    compile_space,
)


def _esc(s) -> str:
    return str(s).replace("\\", "\\\\").replace('"', '\\"')


def _param_desc(spec) -> str:
    if spec.kind == "categorical":
        return f"choice[{spec.n_options}]"
    args = []
    if spec.low is not None:
        args += [f"{spec.low:g}", f"{spec.high:g}"]
    if spec.mu is not None:
        args += [f"{spec.mu:g}", f"{spec.sigma:g}"]
    if spec.q:
        args.append(f"q={spec.q:g}")
    return f"{spec.kind}({', '.join(args)})"


def dot_hyperparameters(space) -> str:
    """DOT source for the space's parameter tree."""
    cs = compile_space(space)
    lines = ["digraph space {",
             '  node [fontsize=10, shape=box, style="rounded"];']
    counter = [0]

    def nid():
        counter[0] += 1
        return f"n{counter[0]}"

    def emit(node, parent=None, edge_label=None):
        tag = node[0]
        me = nid()
        if tag == _T_PARAM:
            spec = cs.params[node[1]]
            lines.append(
                f'  {me} [label="{_esc(spec.label)}\\n'
                f'{_esc(_param_desc(spec))}", color=steelblue];')
        elif tag == _T_CHOICE:
            spec = cs.params[node[1]]
            lines.append(
                f'  {me} [label="{_esc(spec.label)}\\nchoice", '
                f"shape=diamond, color=darkorange];")
            for b, branch in enumerate(node[2]):
                emit(branch, me, str(b))
        elif tag == _T_DICT:
            lines.append(f'  {me} [label="dict", color=gray50];')
            for k, v in node[1]:
                emit(v, me, _esc(k))
        elif tag in (_T_LIST, _T_TUPLE):
            kind = "list" if tag == _T_LIST else "tuple"
            lines.append(f'  {me} [label="{kind}", color=gray50];')
            for i, v in enumerate(node[1]):
                emit(v, me, str(i))
        elif tag == _T_APPLY:
            lines.append(f'  {me} [label="scope.{_esc(node[1])}", '
                         f"shape=ellipse, color=mediumpurple];")
            for i, a in enumerate(node[2]):
                emit(a, me, str(i))
        elif tag == _T_SWITCH:
            lines.append(f'  {me} [label="switch", shape=diamond, '
                         f"color=darkorange];")
            emit(node[1], me, "idx")
            for b, branch in enumerate(node[2]):
                emit(branch, me, str(b))
        elif tag == _T_LITERAL:
            lines.append(
                f'  {me} [label="{_esc(repr(node[1]))}", '
                f"color=gray80, fontcolor=gray40];")
        if parent is not None:
            lbl = f' [label="{edge_label}", fontsize=9]' if edge_label else ""
            lines.append(f"  {parent} -> {me}{lbl};")

    emit(cs.template)
    lines.append("}")
    return "\n".join(lines)
