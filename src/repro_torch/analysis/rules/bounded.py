"""bounded-loops: every step-loop ``while`` ends at an integer ceiling.

The reference keeps failure in data: a diverging lane is quarantined by
its retcode while the shared loop runs on for the healthy lanes.  That
ends only if each loop's condition, besides its value tests (residual
norms, ``t < tf``, ``retcode == 0``), also compares a counter with an
integer ceiling of the options (``att < opts.max_steps``, ``it <
maxiter``): a loop held only by floats spins forever once a lane's
values turn NaN.  The reference checks its ``while_loop`` jaxprs; the
port's step loops are Python, so this rule reads their source
(``core/batched.py``, ``arkode.py``, ``cvode.py``, ``kinsol.py``,
``krylov.py``, ``events.py``) with ``ast``.

A loop's guard is its test, or for ``while True:`` the ``if not C:
break`` (or ``if E: break``) among the simple statements that open its
body.  The guard bounds the loop when it holds an ordered comparison
(``<``, ``<=``, ``>``, ``>=``) of a counter with a ceiling name (the
context's ``loop_ceilings``: ``max_steps``, ``maxiter``, ``max_iters``,
``max_restarts``, ``newton_max``, ...) that stops the loop when the
counter reaches it: under ``and`` (``&``) of a continue condition, or
``or`` (``|``) of an exit condition, through calls (a call's arguments,
a method's receiver, and the ``return`` of a helper function of the same
module, such as ``arkode._go_on``).  A float test such as ``t < tf`` or
an equality test does not count.
"""
import ast

from .. import lint

_ORDERED = (ast.Lt, ast.LtE, ast.Gt, ast.GtE)


def _names(node) -> set:
    """Identifiers of the names and attributes in an expression."""
    out = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            out.add(sub.id)
        elif isinstance(sub, ast.Attribute):
            out.add(sub.attr)
    return out


class _Guard:
    """Decides whether a guard expression bounds its loop."""

    def __init__(self, ceilings, helpers):
        self.ceilings, self.helpers = ceilings, helpers

    def _compare(self, node: ast.Compare, go_on: bool) -> bool:
        left = node.left
        for op, right in zip(node.ops, node.comparators):
            if isinstance(op, _ORDERED):
                lo, hi = (left, right) if isinstance(op, (ast.Lt, ast.LtE)) \
                    else (right, left)
                # continue while lo < hi, with hi the ceiling; exit once
                # the counter lo' >= hi' (so hi' above lo') is the ceiling
                ceiling = hi if go_on else lo
                if _names(ceiling) & self.ceilings:
                    return True
            left = right
        return False

    def bounds(self, node, go_on: bool, depth: int = 0) -> bool:
        """Whether ``node`` bounds the loop as a continue condition
        (``go_on``) or an exit condition."""
        if depth > 8:
            return False
        if isinstance(node, ast.Compare):
            return self._compare(node, go_on)
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
            return self.bounds(node.operand, not go_on, depth + 1)
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
            return self.bounds(node.operand, not go_on, depth + 1)
        conj = None
        if isinstance(node, ast.BoolOp):
            conj, parts = isinstance(node.op, ast.And), node.values
        elif isinstance(node, ast.BinOp) and \
                isinstance(node.op, (ast.BitAnd, ast.BitOr)):
            conj, parts = isinstance(node.op, ast.BitAnd), \
                [node.left, node.right]
        if conj is not None:
            hits = [self.bounds(p, go_on, depth + 1) for p in parts]
            # a continue condition's "and", an exit condition's "or": one
            # bounded part is enough; otherwise every part must bound
            return any(hits) if conj == go_on else all(hits)
        if isinstance(node, ast.Call):
            parts = list(node.args)
            if isinstance(node.func, ast.Attribute):
                parts.append(node.func.value)
            elif isinstance(node.func, ast.Name) and \
                    node.func.id in self.helpers:
                parts += self.helpers[node.func.id]
            return any(self.bounds(p, go_on, depth + 1) for p in parts)
        return False


def _head_guard(loop: ast.While):
    """``(guard, go_on)`` of a ``while True:`` loop: the test of the
    first ``if ...: break`` among its opening simple statements."""
    for stmt in loop.body:
        if isinstance(stmt, ast.If):
            if len(stmt.body) == 1 and isinstance(stmt.body[0], ast.Break) \
                    and not stmt.orelse:
                if isinstance(stmt.test, ast.UnaryOp) and \
                        isinstance(stmt.test.op, ast.Not):
                    return stmt.test.operand, True
                return stmt.test, False
            return None, True
        if not isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign,
                                 ast.Expr)):
            return None, True
    return None, True


def _helpers(tree) -> dict:
    """Module-level functions -> the expressions they return."""
    out = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            out[node.name] = [r.value for r in ast.walk(node)
                              if isinstance(r, ast.Return) and r.value]
    return out


@lint.register(
    "bounded-loops",
    "every while of the step loops compares a counter with an integer "
    "ceiling of the options (max_steps, maxiter, ...)")
def check(ctx):
    out = []
    for source in ctx.loop_sources:
        tree = ast.parse(source.read(), filename=str(source.path))
        guard = _Guard(set(ctx.loop_ceilings), _helpers(tree))
        for loop in ast.walk(tree):
            if not isinstance(loop, ast.While):
                continue
            if isinstance(loop.test, ast.Constant) and loop.test.value:
                test, go_on = _head_guard(loop)
            else:
                test, go_on = loop.test, True
            if test is not None and guard.bounds(test, go_on):
                continue
            what = "has no 'if ...: break' at its head" if test is None \
                else "compares no counter with an integer ceiling " \
                     f"({', '.join(sorted(ctx.loop_ceilings))})"
            out.append(lint.Violation(
                "bounded-loops", f"{source.name}:{loop.lineno}",
                f"while loop {what}: a NaN lane can spin it forever",
                src=(str(source.path), loop.lineno)))
    return out
