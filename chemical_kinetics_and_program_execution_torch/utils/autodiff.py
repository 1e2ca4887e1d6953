"""What the port's hand-written backward rules share.

``flatten_args`` takes an ``args`` channel apart (the rate parameters
that the solvers pass to ``fn``), so that a `torch.autograd.Function`
can take its tensors as inputs. ``first_order_only`` guards a cotangent
that a backward rule formed outside autograd's graph (a kernel's output,
or a sum of `torch.autograd.grad` results taken without a graph): under
``create_graph`` it marks the cotangent as a function of the rule's
inputs whose own derivative raises NotImplementedError naming
`SECOND_ORDER`, where it would otherwise carry no graph and give a
second derivative that is silently wrong.
"""

from __future__ import annotations

import torch

# The ROADMAP Queue 1 item that second derivatives wait on (with the
# derivatives of the world mass, K9).
SECOND_ORDER = ("ROADMAP Queue 1, 'Second derivatives and derivatives of the "
                "world mass'")


def flatten_args(args):
    """``(tensors, rebuild)``: the tensors of ``args`` (a tensor, a tuple,
    list or dict of tensors and other values, or any other value, which
    holds none) and the map back from a list of tensors in their
    place."""
    if isinstance(args, torch.Tensor):
        return [args], lambda ts: ts[0]
    if isinstance(args, dict):
        keys = [k for k, x in args.items() if isinstance(x, torch.Tensor)]

        def rebuild_dict(ts):
            out = dict(args)
            out.update(zip(keys, ts))
            return out

        return [args[k] for k in keys], rebuild_dict
    if isinstance(args, (tuple, list)):
        at = [i for i, x in enumerate(args) if isinstance(x, torch.Tensor)]

        def rebuild_seq(ts):
            out = list(args)
            for i, t in zip(at, ts):
                out[i] = t
            return type(args)(out)

        return [args[i] for i in at], rebuild_seq
    return [], lambda ts: args


class _FirstOrderOnly(torch.autograd.Function):
    """The identity on a cotangent (``apply(x, what, *anchors)``), whose
    own backward raises NotImplementedError naming `SECOND_ORDER`;
    ``anchors`` make it part of the graph."""

    @staticmethod
    def forward(x, what, *anchors):
        return x.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.what = inputs[1]

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            f"second derivatives through {ctx.what} are not ported yet "
            f"({SECOND_ORDER})")


def first_order_only(x, what: str, *anchors):
    """``x`` itself unless grad mode is on (a backward run with
    ``create_graph``); then ``x`` tied to ``anchors`` (the tensors it is
    a function of: a rule's saved inputs and its incoming cotangent; None
    is skipped), its derivative raising NotImplementedError naming
    `SECOND_ORDER` and ``what``. None stays None."""
    if x is None or not torch.is_grad_enabled():
        return x
    return _FirstOrderOnly.apply(
        x, what, *(a for a in anchors if a is not None))
