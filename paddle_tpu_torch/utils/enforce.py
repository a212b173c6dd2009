"""Error-enforcement machinery.

TPU-native analog of the reference's ``PADDLE_ENFORCE*`` macros
(reference: paddle/fluid/platform/enforce.h:270) — raises structured Python
exceptions carrying op attribution so failures point at the offending IR op
(reference: paddle/fluid/framework/op_call_stack.cc).
"""

import traceback


class EnforceError(RuntimeError):
    """Framework error with optional op attribution and user callstack."""

    def __init__(self, message, op_type=None, op_callstack=None):
        self.op_type = op_type
        self.op_callstack = op_callstack
        parts = [message]
        if op_type is not None:
            parts.append(f"  [operator < {op_type} > error]")
        if op_callstack:
            parts.append("  [user callstack]\n" + "".join(op_callstack))
        super().__init__("\n".join(parts))


def enforce(cond, message="enforce failed", op_type=None):
    if not cond:
        raise EnforceError(message, op_type=op_type)


def user_callstack(skip=2, limit=6):
    """Capture the user-side Python stack for op attribution, mirroring the
    callstack attr the reference attaches to every OpDesc."""
    stack = traceback.format_stack()
    stack = [f for f in stack[:-skip] if "paddle_tpu" not in f]
    return stack[-limit:]
