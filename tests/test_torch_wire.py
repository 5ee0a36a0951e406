"""The port's control-plane messages against the JAX package's, byte for
byte.

Every message class of the eight codec modules (``common``, ``enums``,
``scheduler_to_worker``, ``worker_to_scheduler``, ``iterator_to_scheduler``,
``telemetry``, ``explain``, ``admission``) is built from the same seeded
fields in both packages: the bytes must be equal, and each package must
decode the other's bytes to equal fields. The JAX package's ``common``,
``enums`` and ``iterator_to_scheduler`` modules are protoc's; the port's
are hand-rolled on ``wire.py``. The frozen protoc fixtures under
``shockwave_tpu/runtime/protobuf/legacy/`` decode in the port; a
truncated message raises ValueError in both packages; ``fastwire``'s
columnar SubmitJobs block round-trips to the JAX package's columns.

The transport around the messages is the port's own (sockets, not gRPC:
ROADMAP.md, queue 3); this file holds the bytes inside it.
"""

import inspect
import re
import zlib

import numpy as np
import pytest

pytest.importorskip("google.protobuf")

from shockwave_tpu.runtime.protobuf import (  # noqa: E402
    admission_pb2 as jax_adm,
    common_pb2 as jax_common,
    enums_pb2 as jax_enums,
    explain_pb2 as jax_explain,
    fastwire as jax_fastwire,
    iterator_to_scheduler_pb2 as jax_it,
    scheduler_to_worker_pb2 as jax_s2w,
    telemetry_pb2 as jax_tel,
    worker_to_scheduler_pb2 as jax_w2s,
)
from shockwave_tpu.runtime.protobuf.legacy import (  # noqa: E402
    scheduler_to_worker_pb2 as legacy_s2w,
    worker_to_scheduler_pb2 as legacy_w2s,
)
from shockwave_tpu_torch.runtime.protobuf import (  # noqa: E402
    admission_pb2 as port_adm,
    common_pb2 as port_common,
    enums_pb2 as port_enums,
    explain_pb2 as port_explain,
    fastwire as port_fastwire,
    iterator_to_scheduler_pb2 as port_it,
    scheduler_to_worker_pb2 as port_s2w,
    telemetry_pb2 as port_tel,
    worker_to_scheduler_pb2 as port_w2s,
)

# The hand-rolled modules both packages share the shape of.
HAND_ROLLED = [
    (jax_s2w, port_s2w), (jax_w2s, port_w2s), (jax_tel, port_tel),
    (jax_explain, port_explain), (jax_adm, port_adm),
]


def _classes(module):
    return sorted(
        name for name, obj in vars(module).items()
        if inspect.isclass(obj) and obj.__module__ == module.__name__
        and hasattr(obj, "SerializeToString") and hasattr(obj, "FromString")
    )


HAND_ROLLED_CASES = [
    (jax_mod, port_mod, name)
    for jax_mod, port_mod in HAND_ROLLED for name in _classes(jax_mod)
]


def test_the_port_has_every_message_class():
    for jax_mod, port_mod in HAND_ROLLED:
        assert _classes(port_mod) == _classes(jax_mod)
    assert len(HAND_ROLLED_CASES) >= 15


def _text(rng) -> str:
    alphabet = "abcXYZ019 -_=/.:%é中"
    n = int(rng.integers(0, 12))
    return "".join(alphabet[int(i)] for i in rng.integers(0, len(alphabet), n))


def _value(rng, annotation: str, jax_mod, port_mod, nested_depth=0):
    """A seeded value for a constructor parameter's annotation, as a pair
    (for the JAX package's class, for the port's): nested messages are
    built in each package's own class."""
    ann = annotation.replace("Optional[", "").rstrip("]")
    m = re.match(r"List\[(\w+)", ann)
    if m:
        inner = m.group(1)
        # Some lists run past the bulk-codec threshold (32 values).
        n = int(rng.choice([0, 1, 3, 40]))
        if inner in ("int", "float", "str"):
            pairs = [_value(rng, inner, jax_mod, port_mod) for _ in range(n)]
        else:
            pairs = [_message(rng, jax_mod, port_mod, inner, nested_depth + 1)
                     for _ in range(min(n, 4))]
        return [p[0] for p in pairs], [p[1] for p in pairs]
    if ann == "int":
        v = int(rng.choice([0, int(rng.integers(1, 200)),
                            int(rng.integers(0, 2**40))]))
    elif ann == "float":
        v = float(rng.choice([0.0, float(np.round(rng.uniform(-1e6, 1e6), 3)),
                              float(rng.uniform(0, 1))]))
    elif ann == "bool":
        v = bool(rng.integers(0, 2))
    elif ann == "bytes":
        v = bytes(rng.integers(0, 256, int(rng.integers(0, 20)),
                               dtype=np.uint8))
    elif ann == "str":
        v = _text(rng)
    else:
        raise AssertionError(f"no generator for {annotation!r}")
    return v, v


def _message(rng, jax_mod, port_mod, name, nested_depth=0):
    cls = getattr(jax_mod, name)
    params = inspect.signature(cls.__init__).parameters
    jax_kw, port_kw = {}, {}
    for pname, param in params.items():
        if pname == "self":
            continue
        if pname == "jobs_columnar":
            continue  # a block of its own, held below
        a, b = _value(rng, str(param.annotation), jax_mod, port_mod,
                      nested_depth)
        jax_kw[pname], port_kw[pname] = a, b
    return cls(**jax_kw), getattr(port_mod, name)(**port_kw)


def _fields(msg):
    """A message's fields as plain values, nested messages included."""
    out = {}
    for key, value in vars(msg).items():
        if isinstance(value, list):
            value = [_fields(v) if hasattr(v, "SerializeToString") else v
                     for v in value]
        elif hasattr(value, "SerializeToString"):
            value = _fields(value)
        out[key] = value
    return out


@pytest.mark.parametrize("jax_mod,port_mod,name", HAND_ROLLED_CASES,
                         ids=[f"{m.__name__.rsplit('.', 1)[1]}.{n}"
                              for m, _, n in HAND_ROLLED_CASES])
def test_hand_rolled_messages_match_the_jax_package(jax_mod, port_mod, name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    for trial in range(12):
        jax_msg, port_msg = _message(rng, jax_mod, port_mod, name)
        jax_bytes = jax_msg.SerializeToString()
        port_bytes = port_msg.SerializeToString()
        assert port_bytes == jax_bytes, (name, trial)
        port_read = getattr(port_mod, name).FromString(jax_bytes)
        jax_read = getattr(jax_mod, name).FromString(port_bytes)
        assert _fields(port_read) == _fields(jax_read), (name, trial)
        assert port_read.SerializeToString() == jax_bytes


# The three protoc modules of the JAX package: (class, {field: kind}).
PROTOC = [
    ("common", "Empty", {}),
    ("common", "JobState", {"job_id": "u32", "status": "enum"}),
    ("it", "InitJobRequest", {"job_id": "u64"}),
    ("it", "UpdateLeaseRequest", {
        "job_id": "u64", "worker_id": "u64", "steps": "u64",
        "duration": "f64", "max_steps": "u64", "max_duration": "f64"}),
    ("it", "UpdateLeaseResponse", {
        "max_steps": "u64", "max_duration": "f64", "extra_time": "f64"}),
]
MODULES = {"common": (jax_common, port_common), "it": (jax_it, port_it)}


def _protoc_value(rng, kind):
    if kind == "u32":
        return int(rng.choice([0, int(rng.integers(1, 2**32))]))
    if kind == "u64":
        return int(rng.choice([0, int(rng.integers(1, 2**62)), 10**9]))
    if kind == "enum":
        return int(rng.integers(0, 5))
    return float(rng.choice([0.0, float(rng.uniform(0, 1e4)), 12.25]))


@pytest.mark.parametrize("module,name,kinds", PROTOC,
                         ids=[f"{m}.{n}" for m, n, _ in PROTOC])
def test_protoc_messages_match_the_hand_rolled_port(module, name, kinds):
    jax_mod, port_mod = MODULES[module]
    rng = np.random.default_rng(len(name))
    for _ in range(20):
        fields = {f: _protoc_value(rng, k) for f, k in kinds.items()}
        jax_msg = getattr(jax_mod, name)(**fields)
        port_msg = getattr(port_mod, name)(**fields)
        assert port_msg.SerializeToString() == jax_msg.SerializeToString()
        port_read = getattr(port_mod, name).FromString(
            jax_msg.SerializeToString())
        jax_read = getattr(jax_mod, name).FromString(
            port_msg.SerializeToString())
        for f in kinds:
            assert getattr(port_read, f) == getattr(jax_read, f) == fields[f]


def test_enums_match_the_jax_package():
    for enum in ("DeviceType", "JobStatus"):
        jax_enum = getattr(jax_enums, enum)
        port_enum = getattr(port_enums, enum)
        assert dict(port_enum.items()) == dict(jax_enum.items())
        for name, number in jax_enum.items():
            assert port_enum.Name(number) == jax_enum.Name(number) == name
            assert getattr(port_enums, name) == getattr(jax_enums, name)
    with pytest.raises(ValueError):
        port_enums.JobStatus.Name(99)


def _legacy_value(rng, field):
    from google.protobuf.descriptor import FieldDescriptor as F

    def one():
        if field.type == F.TYPE_STRING:
            return _text(rng)
        if field.type == F.TYPE_BOOL:
            return bool(rng.integers(0, 2))
        if field.type == F.TYPE_DOUBLE:
            return float(rng.uniform(0, 1e3))
        if field.type == F.TYPE_ENUM:
            return int(rng.integers(0, 5))
        if field.type in (F.TYPE_UINT32, F.TYPE_INT32):
            return int(rng.integers(0, 2**31))
        if field.type in (F.TYPE_UINT64, F.TYPE_INT64):
            return int(rng.integers(0, 2**40))
        raise AssertionError(field.type)

    repeated = getattr(field, "is_repeated", None)
    if repeated is None:
        repeated = field.label == field.LABEL_REPEATED
    if repeated:
        return [one() for _ in range(int(rng.choice([0, 2, 40])))]
    return one()


LEGACY = [(legacy_s2w, port_s2w, name) for name in
          ("JobDescription", "KillJobRequest")] + [
          (legacy_w2s, port_w2s, name) for name in
          ("RegisterWorkerRequest", "RegisterWorkerResponse", "Heartbeat",
           "DoneRequest")]


@pytest.mark.parametrize("legacy,port_mod,name", LEGACY,
                         ids=[n for _, _, n in LEGACY])
def test_legacy_protoc_fixtures_decode_in_the_port(legacy, port_mod, name):
    """The frozen protoc messages, seeded over every field of their
    descriptor, decode in the port to the same values, and the port
    re-encodes them to protoc's bytes."""
    cls = getattr(legacy, name)
    rng = np.random.default_rng(7 + len(name))
    for _ in range(10):
        msg = cls()
        for field in cls.DESCRIPTOR.fields:
            if field.message_type is not None:
                continue
            value = _legacy_value(rng, field)
            if isinstance(value, list):
                getattr(msg, field.name).extend(value)
            else:
                setattr(msg, field.name, value)
        data = msg.SerializeToString()
        port_read = getattr(port_mod, name).FromString(data)
        for field in cls.DESCRIPTOR.fields:
            if field.message_type is not None:
                continue
            want = getattr(msg, field.name)
            got = getattr(port_read, field.name)
            if isinstance(got, list):
                assert list(got) == list(want), field.name
            else:
                assert got == want, field.name
        assert port_read.SerializeToString() == data


def test_legacy_run_job_request_with_nested_descriptions():
    msg = legacy_s2w.RunJobRequest(worker_id=3, round_id=17)
    for i in range(3):
        d = msg.job_descriptions.add()
        d.job_id, d.job_type, d.command = i, f"T{i}", f"python3 x.py {i}"
        d.num_steps, d.has_duration, d.duration = 100 * i, bool(i), 9 * i
    data = msg.SerializeToString()
    port_read = port_s2w.RunJobRequest.FromString(data)
    assert [d.job_id for d in port_read.job_descriptions] == [0, 1, 2]
    assert [d.command for d in port_read.job_descriptions] == [
        "python3 x.py 0", "python3 x.py 1", "python3 x.py 2"]
    assert port_read.SerializeToString() == data


TRUNCATABLE = [
    ("s2w.RunJobRequest", jax_s2w, port_s2w, "RunJobRequest",
     dict(job_descriptions=None, worker_id=300, round_id=7)),
    ("w2s.DoneRequest", jax_w2s, port_w2s, "DoneRequest",
     dict(worker_id=1, job_id=[4, 5], num_steps=[10, 20],
          execution_time=[1.5, 2.5], iterator_log=["a", "b"])),
    ("w2s.RegisterWorkerRequest", jax_w2s, port_w2s,
     "RegisterWorkerRequest",
     dict(worker_type="v100", num_accelerators=2, ip_addr="10.0.0.1",
          port=50061, client_send_s=12.5)),
    ("adm.SubmitJobsResponse", jax_adm, port_adm, "SubmitJobsResponse",
     dict(status="ACCEPTED", retry_after_s=1.5, admitted=3,
          queue_depth=9)),
    ("tel.MetricsDump", jax_tel, port_tel, "MetricsDump",
     dict(text="x" * 300)),
    ("explain.ExplainJobResponse", jax_explain, port_explain,
     "ExplainJobResponse", dict(found=True, narrative_json="{}" * 20)),
]


@pytest.mark.parametrize("label,jax_mod,port_mod,name,fields", TRUNCATABLE,
                         ids=[t[0] for t in TRUNCATABLE])
def test_a_truncated_message_raises_in_both_packages(label, jax_mod,
                                                     port_mod, name, fields):
    data = getattr(jax_mod, name)(**fields).SerializeToString()
    # Cut inside the last field's value (its last byte), which every
    # parser must notice.
    cut = data[:-1]
    for mod in (jax_mod, port_mod):
        with pytest.raises(ValueError):
            getattr(mod, name).FromString(cut)
    # The iterator's lease response, protoc's in the JAX package.
    lease = jax_it.UpdateLeaseResponse(max_steps=5, max_duration=2.5)
    with pytest.raises(ValueError):
        port_it.UpdateLeaseResponse.FromString(
            lease.SerializeToString()[:-2])


def _random_spec(rng, i) -> dict:
    return {
        "job_type": f"ResNet-18 (batch size {int(rng.choice([16, 32]))})",
        "command": f"python3 main.py --run {i} {_text(rng)}",
        "working_directory": _text(rng),
        "num_steps_arg": "-n",
        "total_steps": int(rng.integers(0, 10**7)),
        "scale_factor": int(rng.choice([1, 2, 4])),
        "mode": str(rng.choice(["static", "accordion", "gns"])),
        "priority_weight": float(rng.choice([1.0, 0.5, 2.0])),
        "slo": float(rng.choice([0.0, 1.5])),
        "duration": float(np.round(rng.uniform(0, 1e5), 2)),
        "needs_data_dir": bool(rng.integers(0, 2)),
        "tenant": str(rng.choice(["", "a", "tenant-b"])),
        "trace_context": str(rng.choice(["", "00-abc-def-01"])),
    }


def test_fastwire_columnar_block_roundtrips_to_the_jax_columns():
    rng = np.random.default_rng(23)
    for trial in range(8):
        specs = [_random_spec(rng, i)
                 for i in range(int(rng.integers(1, 60)))]
        port_block = port_fastwire.encode_columnar_block(specs)
        jax_block = jax_fastwire.encode_columnar_block(specs)
        assert port_block == jax_block
        assert (port_fastwire.decode_columnar_block(jax_block).to_spec_dicts()
                == jax_fastwire.decode_columnar_block(port_block)
                .to_spec_dicts() == specs)
        request = port_adm.SubmitJobsRequest(
            token=f"t-{trial}", close=bool(trial % 2),
            jobs_columnar=port_block, wire_caps=port_fastwire.CAP_COLUMNAR)
        data = request.SerializeToString()
        assert data == jax_adm.SubmitJobsRequest(
            token=f"t-{trial}", close=bool(trial % 2),
            jobs_columnar=jax_block,
            wire_caps=jax_fastwire.CAP_COLUMNAR).SerializeToString()
        fast = port_fastwire.FastSubmitRequest.FromString(data)
        assert fast.token == f"t-{trial}"
        assert fast.columns.to_spec_dicts() == specs
    with pytest.raises(ValueError):
        port_fastwire.decode_columnar_block(port_block[:-3])


def test_fastwire_bulk_varints_and_doubles_match_the_jax_package():
    rng = np.random.default_rng(5)
    for n in (1, 31, 32, 33, 500):
        ints = [int(v) for v in rng.integers(0, 2**62, n)]
        doubles = [float(v) for v in rng.normal(size=n)]
        assert (port_fastwire.encode_varints(ints)
                == jax_fastwire.encode_varints(ints))
        assert (port_fastwire.encode_doubles(doubles)
                == jax_fastwire.encode_doubles(doubles))
        blob = jax_fastwire.encode_varints(ints)
        assert port_fastwire.decode_varints(blob).tolist() == ints
