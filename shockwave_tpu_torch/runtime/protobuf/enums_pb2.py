"""Hand-rolled counterpart of the protoc module for ``enums.proto``: the
two enums as module constants, with protoc's ``Name``/``Value`` lookups
on each enum wrapper."""

from __future__ import annotations


class _Enum:
    """An enum's values by name (protoc's EnumTypeWrapper surface)."""

    def __init__(self, name: str, values: dict):
        self.name = name
        self._by_name = dict(values)
        self._by_number = {v: k for k, v in values.items()}

    def Name(self, number: int) -> str:  # noqa: N802 (protobuf API)
        try:
            return self._by_number[int(number)]
        except KeyError:
            raise ValueError(
                f"enum {self.name} has no value with number {number}"
            ) from None

    def Value(self, name: str) -> int:  # noqa: N802 (protobuf API)
        try:
            return self._by_name[name]
        except KeyError:
            raise ValueError(
                f"enum {self.name} has no value named {name}"
            ) from None

    def items(self):
        return list(self._by_name.items())


DeviceType = _Enum(
    "DeviceType",
    {"UNKNOWN_DEVICE": 0, "K80": 1, "P100": 2, "V100": 3, "TPU_V4": 4,
     "TPU_V5E": 5},
)
JobStatus = _Enum(
    "JobStatus",
    {"UNKNOWN_STATUS": 0, "QUEUED": 1, "RUNNING": 2, "SUCCEEDED": 3,
     "FAILED": 4},
)
globals().update(DeviceType.items())
globals().update(JobStatus.items())
