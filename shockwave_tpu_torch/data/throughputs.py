"""Throughput-oracle readers.

Oracle JSON format (reference: scheduler/utils.py:456-476):

  {worker_type: {"('<job_type>', <scale_factor>)":
      {"null": isolated_tput,
       "('<other_job_type>', <sf>)": [tput_self, tput_other]}}}

Keys are stringified ``(job_type, scale_factor)`` tuples; ``"null"`` holds
the isolated throughput (steps/s), other keys hold co-located throughputs
for Gavel-style packing.
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Tuple

JobTypeKey = Tuple[str, int]


def _parse_job_type_key(s: str) -> Optional[JobTypeKey]:
    """Parse "('LM (batch size 10)', 2)" -> ("LM (batch size 10)", 2)."""
    s = s.strip()
    if not (s.startswith("(") and s.endswith(")")):
        return None
    body = s[1:-1]
    comma = body.rfind(",")
    if comma < 0:
        return None
    job_type = body[:comma].strip()
    if job_type[0] in "'\"" and job_type[-1] == job_type[0]:
        job_type = job_type[1:-1]
    return (job_type, int(body[comma + 1 :].strip()))


def read_throughputs(file_name: str) -> Dict[str, Dict[JobTypeKey, dict]]:
    """Read an oracle throughputs JSON into nested dicts keyed by
    (job_type, scale_factor) tuples; colocated entries keep the "null" key."""
    with open(file_name, "r") as f:
        raw = json.load(f)
    parsed: Dict[str, Dict[JobTypeKey, dict]] = {}
    for worker_type, per_type in raw.items():
        parsed[worker_type] = {}
        for job_type_str, entries in per_type.items():
            key = _parse_job_type_key(job_type_str)
            if key is None:
                raise ValueError(f"Bad job-type key: {job_type_str!r}")
            converted = {}
            for other_str, value in entries.items():
                if other_str == "null":
                    converted["null"] = value
                else:
                    other_key = _parse_job_type_key(other_str)
                    if other_key is None:
                        raise ValueError(f"Bad job-type key: {other_str!r}")
                    converted[other_key] = value
            parsed[worker_type][key] = converted
    return parsed



def stringify_throughputs(throughputs: Dict[str, Dict[JobTypeKey, dict]]) -> dict:
    """Inverse of :func:`read_throughputs` for writing oracle files."""
    out: dict = {}
    for worker_type, per_type in throughputs.items():
        out[worker_type] = {}
        for key, entries in per_type.items():
            out[worker_type][str(key)] = {
                ("null" if other == "null" else str(other)): v
                for other, v in entries.items()
            }
    return out
