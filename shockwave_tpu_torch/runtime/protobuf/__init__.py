"""The control plane's messages, encoded by hand on :mod:`.wire` (no
protoc, no ``google.protobuf``). Every message's bytes equal those of the
JAX package's modules of the same names for the same fields; the
``.proto`` files beside them are the contract."""
