"""Device identity ("Place").

Analog of the reference's Place variant (reference:
paddle/fluid/platform/place.h:79 — CUDAPlace/CPUPlace). Each place names
one ``torch.device``; entry points take a place and default to
``CUDAPlace(0)`` (``default_place``), so the card is the default and the
CPU is what a caller asks for explicitly.
"""

import torch

from paddle_tpu_torch.utils.enforce import EnforceError


class Place:
    _kind = "undefined"

    def __init__(self, device_id=0):
        self.device_id = device_id

    def __eq__(self, other):
        return type(self) is type(other) and self.device_id == other.device_id

    def __hash__(self):
        return hash((self._kind, self.device_id))

    def __repr__(self):
        return f"{type(self).__name__}({self.device_id})"


class CPUPlace(Place):
    _kind = "cpu"

    def __init__(self):
        super().__init__(0)

    @property
    def device(self):
        return torch.device("cpu")


class CUDAPlace(Place):
    """One CUDA card, by its index in ``torch.cuda``'s device list."""

    _kind = "cuda"

    @property
    def device(self):
        return torch.device("cuda", self.device_id)


def default_place(place=None):
    """``place`` itself, or ``CUDAPlace(0)`` when it is None. Raises when
    the resolved place is a CUDA card and this process sees none: the
    entry points never carry on on the CPU unless asked to."""
    place = CUDAPlace(0) if place is None else place
    if isinstance(place, CUDAPlace):
        if not torch.cuda.is_available():
            raise EnforceError(
                f"{place} requested but torch sees no CUDA device; pass "
                "place=CPUPlace() to run on the CPU"
            )
        if place.device_id >= torch.cuda.device_count():
            raise EnforceError(
                f"{place} requested but only {torch.cuda.device_count()} "
                "CUDA devices are visible"
            )
    return place
