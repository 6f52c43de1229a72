"""Hand-rolled protobuf (proto3) wire codec for ``inference.proto``.
The port's own copy of ``distributed_inference_server_tpu/serving/
protowire.py`` with its own copy of the schema document
(``serving/inference.proto``): the same tables, so the same bytes. The
disaggregated handoff's ``ProtowireChannel`` frames with it
(``serving/disagg.py``); the gRPC front end is not ported.

The reference spec'd a Tonic (protobuf-binary) gRPC surface
(``design.md:139-155`` [spec]); this image ships grpcio but no protoc
gRPC codegen plugin, so the ~17 message codecs are implemented directly
against the frozen schema in ``serving/inference.proto`` (VERDICT r3
next #5). The length-delimited protobuf wire format needs only three
primitives — varints, fixed32 floats, and length-delimited bytes — and
schema tables keep each message a data entry, not code.

Interface: ``encode(msg, obj) -> bytes`` / ``decode(msg, data) -> dict``
where ``obj``/``dict`` use the SAME canonical JSON-dict schema as the
HTTP endpoints and the JSON-over-gRPC wire (core/models.py ``to_dict``
shapes), including the two documented JSON deviations: TokenEvent is a
tagged union on ``"type"`` and enums are lowercase strings. The gRPC
server auto-detects the wire per request (JSON objects start with
``{``; no message here uses field 15 with group wire type, so the two
encodings are unambiguous) and answers in kind — a protobuf client and
a JSON client see identical payloads, differentially tested.

Decode fills proto3 defaults (0 / "" / false / []) for absent scalar
and repeated fields of RESPONSE messages so reconstructed dicts are
key-for-key identical to the JSON wire; unknown fields are skipped
(forward compatibility), and dict keys outside the schema are ignored
on encode (e.g. EngineStatus's optional ``speculation`` block, which
the proto schema does not carry).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple

# -- wire primitives --------------------------------------------------------

_VARINT = 0
_FIXED64 = 1
_LEN = 2
_FIXED32 = 5


def _enc_varint(value: int) -> bytes:
    if value < 0:
        # proto3 negative int64/int32 encode as 10-byte two's complement
        value &= (1 << 64) - 1
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _dec_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise ValueError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint too long")


def _key(field: int, wire: int) -> bytes:
    return _enc_varint((field << 3) | wire)


def _signed64(value: int) -> int:
    return value - (1 << 64) if value >= (1 << 63) else value


# -- schema -----------------------------------------------------------------

ENUMS: Dict[str, Dict[int, Optional[str]]] = {
    "Role": {1: "system", 2: "user", 3: "assistant"},
    "FinishReason": {1: "stop", 2: "length", 3: "stop_sequence"},
    "Priority": {1: "low", 2: "normal", 3: "high"},
}
_ENUM_TO_NUM = {
    name: {v: k for k, v in table.items() if v is not None}
    for name, table in ENUMS.items()
}

# field entry: (name, type, cardinality) where type is one of
# "string" "uint32" "uint64" "int64" "bool" "float" "double" "enum:<E>"
# "msg:<M>"
# and cardinality is "one" (implicit presence: zero omitted, default
# filled on decode), "opt" (explicit presence: emitted iff present in
# the dict and not None; absent from the decoded dict otherwise), or
# "rep" (repeated; packed scalars supported both ways).
_F = Tuple[str, str, str]
MESSAGES: Dict[str, Dict[int, _F]] = {
    # request numeric knobs are proto3 `optional` (explicit presence):
    # absent -> server default applies; explicit 0 is honored
    # (temperature 0 = greedy)
    "GenerateRequest": {
        1: ("prompt", "string", "one"),
        2: ("max_tokens", "uint32", "opt"),
        3: ("temperature", "float", "opt"),
        4: ("top_p", "float", "opt"),
        5: ("stop_sequences", "string", "rep"),
        6: ("stream", "bool", "one"),
        7: ("priority", "enum:Priority", "opt"),
    },
    "ChatMessage": {
        1: ("role", "enum:Role", "one"),
        2: ("content", "string", "one"),
    },
    "ChatRequest": {
        1: ("messages", "msg:ChatMessage", "rep"),
        2: ("max_tokens", "uint32", "opt"),
        3: ("temperature", "float", "opt"),
        4: ("top_p", "float", "opt"),
        5: ("stop_sequences", "string", "rep"),
        6: ("stream", "bool", "one"),
    },
    "EmbeddingsRequest": {
        1: ("input", "string", "rep"),
        2: ("model", "string", "opt"),
    },
    "HealthRequest": {},
    "Usage": {
        1: ("prompt_tokens", "uint32", "one"),
        2: ("completion_tokens", "uint32", "one"),
        3: ("total_tokens", "uint32", "one"),
    },
    "GenerateChoice": {
        1: ("text", "string", "one"),
        2: ("index", "uint32", "one"),
        3: ("finish_reason", "enum:FinishReason", "one"),
    },
    "GenerateResponse": {
        1: ("id", "string", "one"),
        2: ("object", "string", "one"),
        3: ("created", "int64", "one"),
        4: ("model", "string", "one"),
        5: ("choices", "msg:GenerateChoice", "rep"),
        6: ("usage", "msg:Usage", "opt"),
    },
    "ChatChoice": {
        1: ("index", "uint32", "one"),
        2: ("message", "msg:ChatMessage", "opt"),
        3: ("finish_reason", "enum:FinishReason", "one"),
    },
    "ChatResponse": {
        1: ("id", "string", "one"),
        2: ("object", "string", "one"),
        3: ("created", "int64", "one"),
        4: ("model", "string", "one"),
        5: ("choices", "msg:ChatChoice", "rep"),
        6: ("usage", "msg:Usage", "opt"),
    },
    "EmbeddingData": {
        1: ("object", "string", "one"),
        2: ("embedding", "float", "rep"),
        3: ("index", "uint32", "one"),
    },
    "EmbeddingsResponse": {
        1: ("object", "string", "one"),
        2: ("data", "msg:EmbeddingData", "rep"),
        3: ("model", "string", "one"),
        4: ("usage", "msg:Usage", "opt"),
    },
    "EngineStatus": {
        1: ("engine_id", "string", "one"),
        2: ("healthy", "bool", "one"),
        3: ("active_requests", "uint32", "one"),
        4: ("waiting_requests", "uint32", "one"),
        # uint64 to match inference.proto exactly (distlint DL005): the
        # varint bytes are identical for counts < 2^63, but a signed
        # decode would misread a colossal counter as negative
        5: ("total_processed", "uint64", "one"),
        6: ("memory_used_pages", "uint32", "one"),
        7: ("memory_total_pages", "uint32", "one"),
        # disaggregation role (serving/disagg.py); "unified" when the
        # topology is monolithic, so it is always on the wire
        8: ("role", "string", "one"),
        # reclaimable refcount-0 prefix pages within memory_used_pages
        9: ("pages_cached", "uint32", "one"),
        # fleet heartbeat payload (serving/fleet.py): the routing digest
        # travels with the status so the registry host's cache_aware
        # cost model can score a remote member's cached prefix chains
        10: ("prefix_digest", "uint64", "rep"),
        11: ("page_size", "uint32", "one"),
        12: ("digest_depth", "uint32", "one"),
        13: ("host_tier_bytes", "uint64", "one"),
        14: ("host_tier_pages", "uint32", "one"),
    },
    "HealthResponse": {
        1: ("status", "string", "one"),
        2: ("accepting", "bool", "one"),
        3: ("engines", "msg:EngineStatus", "rep"),
    },
    # TokenEvent's oneof members; the tagged-union translation to the
    # JSON shape happens in encode/decode_token_event below
    "TokenEvent.Token": {
        1: ("token", "string", "one"),
        2: ("index", "uint32", "one"),
        3: ("logprob", "float", "opt"),
    },
    "TokenEvent.Done": {
        1: ("finish_reason", "enum:FinishReason", "one"),
        2: ("usage", "msg:Usage", "opt"),
    },
    "TokenEvent.StreamError": {
        1: ("messages", "string", "one"),
        2: ("code", "string", "one"),
    },
    "TokenEvent": {
        1: ("token", "msg:TokenEvent.Token", "opt"),
        2: ("done", "msg:TokenEvent.Done", "opt"),
        3: ("error", "msg:TokenEvent.StreamError", "opt"),
    },
    # Multi-host fleet control plane (serving/fleet.py,
    # serving/remote_runner.py; docs/FLEET.md): a worker member's
    # heartbeat, the registry host's forwarded request, and the streamed
    # result events — the three frame kinds of the fleet wire.
    "FleetHeartbeat": {
        1: ("member_id", "string", "one"),
        2: ("seq", "uint64", "one"),
        3: ("engines", "msg:EngineStatus", "rep"),
        # fleet KV data plane (serving/fleet_kv.py): the member's KV
        # data listener port; 0 = no data plane
        4: ("data_port", "uint32", "one"),
    },
    "FleetSubmit": {
        1: ("request_id", "string", "one"),
        2: ("engine_id", "string", "one"),
        3: ("prompt_ids", "uint32", "rep"),
        4: ("max_tokens", "uint32", "one"),
        # double, not float: cross-host token identity needs the
        # sampling params bit-exact (same rationale as KvHandoff)
        5: ("temperature", "double", "one"),
        6: ("top_p", "double", "one"),
        7: ("stop_sequences", "string", "rep"),
        8: ("tenant", "string", "one"),
        9: ("abort", "bool", "one"),
        # distributed trace context (docs/OBSERVABILITY.md): the member
        # parents its fleet.serve span on this; "" = untraced
        10: ("trace_id", "string", "one"),
        11: ("parent_span_id", "string", "one"),
        # KV mesh fetch hint (serving/fleet_mesh.py): the registry host
        # attaches the fetch plan to the submit it was sending anyway,
        # and the member pulls the prefix straight from the named peer
        # over its own mesh channel — bulk bytes skip the registry.
        # fetch_member "" = no hint; old members skip unknown fields
        # and serve by recompute (graceful degradation).
        12: ("fetch_member", "string", "one"),
        13: ("fetch_source_engine", "string", "one"),
        14: ("fetch_hashes", "uint64", "rep"),
        15: ("fetch_chunk_pages", "uint32", "one"),
        16: ("fetch_wire_quant", "string", "one"),
        # registry HA epoch fence (serving/fleet_ha.py): members accept
        # control only from the highest epoch seen; 0 = unfenced legacy
        17: ("epoch", "uint64", "one"),
    },
    # KV mesh introduction (serving/fleet_mesh.py; docs/FLEET.md "KV
    # mesh"): the registry host brokers member↔member data-plane
    # endpoints over fleet-wire frame kind 6; gone=true retracts a dead
    # member's endpoint.
    "KvIntro": {
        1: ("member_id", "string", "one"),
        2: ("host", "string", "one"),
        3: ("data_port", "uint32", "one"),
        4: ("max_streams", "uint32", "one"),
        5: ("gone", "bool", "one"),
        # registry HA epoch fence (serving/fleet_ha.py): stale-epoch
        # intros from a fenced registry are ignored by members
        6: ("epoch", "uint64", "one"),
    },
    # Registry HA control wire (serving/fleet_ha.py; docs/FLEET.md
    # "Registry HA"): the primary's lease beat (frame kind 7) and a
    # standby's state echo (frame kind 8), exchanged registry↔registry
    # over the same fleet wire. Epochs are monotonic across takeovers
    # and fence partitioned old primaries.
    "RegistryLease": {
        1: ("registry_id", "string", "one"),
        2: ("epoch", "uint64", "one"),
        3: ("seq", "uint64", "one"),
        4: ("role", "string", "one"),
    },
    "RegistryState": {
        1: ("registry_id", "string", "one"),
        2: ("epoch", "uint64", "one"),
        3: ("role", "string", "one"),
    },
    "FleetEvent": {
        1: ("request_id", "string", "one"),
        2: ("engine_id", "string", "one"),
        3: ("kind", "string", "one"),
        4: ("token_id", "uint32", "opt"),
        5: ("text", "string", "one"),
        6: ("token_index", "uint32", "one"),
        7: ("logprob", "float", "opt"),
        8: ("finish_reason", "string", "one"),
        9: ("prompt_tokens", "uint32", "one"),
        10: ("completion_tokens", "uint32", "one"),
        11: ("message", "string", "one"),
        12: ("code", "string", "one"),
    },
    # Fleet-stitched distributed tracing (docs/OBSERVABILITY.md):
    # finished member spans batched back to the registry host at
    # heartbeat cadence (fleet-wire frame kind 4). Timestamps are EPOCH
    # nanoseconds — each process re-bases its own monotonic clock on the
    # wire, so the receiver can merge into its own monotonic domain.
    "TraceEvent": {
        1: ("offset_ns", "uint64", "one"),
        2: ("name", "string", "one"),
        3: ("attrs_json", "string", "one"),
    },
    "TraceSpan": {
        1: ("name", "string", "one"),
        2: ("trace_id", "string", "one"),
        3: ("span_id", "string", "one"),
        4: ("parent_id", "string", "one"),
        5: ("start_unix_ns", "uint64", "one"),
        6: ("duration_ns", "uint64", "one"),
        7: ("status", "string", "one"),
        8: ("attrs_json", "string", "one"),
        9: ("events", "msg:TraceEvent", "rep"),
    },
    "FleetSpans": {
        1: ("member_id", "string", "one"),
        2: ("spans", "msg:TraceSpan", "rep"),
        3: ("dropped", "uint64", "one"),
    },
    # Fleet-federated performance telemetry (serving/teledigest.py;
    # docs/OBSERVABILITY.md "Performance telemetry"): a member's
    # windowed log-bucket digests + cumulative step-clock counters,
    # piggybacked per heartbeat on fleet-wire frame kind 5. Epoch
    # indices are wall-clock aligned (time // epoch_s) so the registry
    # host merges member epochs exactly; bucket/count arrays are
    # parallel and sorted (canonical form — equal contents encode
    # equal bytes).
    "TeleEpoch": {
        1: ("index", "uint64", "one"),
        2: ("buckets", "uint32", "rep"),
        3: ("counts", "uint64", "rep"),
        4: ("n", "uint64", "one"),
        # integer microseconds, not a double: float addition is
        # order-dependent in its last bits, which would break the
        # bit-equality of merged views under re-grouping
        5: ("sum_us", "uint64", "one"),
    },
    "TeleDigest": {
        1: ("name", "string", "one"),
        2: ("epoch_s", "double", "one"),
        3: ("epochs", "msg:TeleEpoch", "rep"),
    },
    "TeleCounter": {
        1: ("name", "string", "one"),
        2: ("value", "double", "one"),
    },
    "FleetTelemetry": {
        1: ("member_id", "string", "one"),
        2: ("digests", "msg:TeleDigest", "rep"),
        3: ("counters", "msg:TeleCounter", "rep"),
    },
    "ErrorDetail": {
        1: ("message", "string", "one"),
        2: ("error_type", "string", "one"),
        3: ("code", "string", "one"),
    },
    "ErrorResponse": {
        1: ("error", "msg:ErrorDetail", "opt"),
    },
    # Streamed KV handoff framing (serving/disagg.py stream_to_frames):
    # header + crc-guarded page-group chunks + a terminal KvHandoff
    # state frame. Payloads are opaque KVP1 bytes (engine/kv_cache.py).
    "KvHandoffHeader": {
        1: ("handoff_id", "string", "one"),
        2: ("request_id", "string", "one"),
        3: ("wire_quant", "string", "one"),
        # distributed trace context (docs/OBSERVABILITY.md)
        4: ("trace_id", "string", "one"),
        5: ("parent_span_id", "string", "one"),
        # fleet KV data plane (serving/fleet_kv.py): stream operation
        # tag ("" = legacy in-process framing), member-local engine id,
        # and the stream geometry the receiver assembles against
        6: ("op", "string", "one"),
        7: ("engine_id", "string", "one"),
        8: ("prefix_pages", "uint32", "one"),
        9: ("total_chunks", "uint32", "one"),
    },
    "KvChunk": {
        1: ("handoff_id", "string", "one"),
        2: ("index", "uint32", "one"),
        3: ("total", "uint32", "one"),
        4: ("page_start", "uint32", "one"),
        5: ("page_count", "uint32", "one"),
        6: ("crc32", "uint32", "one"),
        7: ("payload", "bytes", "one"),
    },
    # Fleet-wide prefix sharing (serving/disagg.py PrefixFetcher): the
    # request half of the fetch_prefix RPC — a cold replica asks a warm
    # peer for a cached prefix chain by content hash; the response
    # reuses the KvHandoffHeader/KvChunk framing above. Hashes are the
    # 63-bit chain_hashes key space, so uint64 carries them exactly.
    "KvPrefixFetch": {
        1: ("request_id", "string", "one"),
        2: ("hashes", "uint64", "rep"),
        3: ("chunk_pages", "uint32", "one"),
        4: ("wire_quant", "string", "one"),
        # distributed trace context (docs/OBSERVABILITY.md)
        5: ("trace_id", "string", "one"),
        6: ("parent_span_id", "string", "one"),
        # fleet KV data plane (serving/fleet_kv.py): which member
        # engine serves the export ("" = in-process fetch)
        7: ("engine_id", "string", "one"),
    },
    # Fleet KV data plane (serving/fleet_kv.py): per-stream terminal
    # status of a member data channel — handoff open/commit/resume acks,
    # fetch-response terminators, and host->member import aborts.
    "KvStreamResult": {
        1: ("stream_id", "string", "one"),
        2: ("op", "string", "one"),
        3: ("ok", "bool", "one"),
        4: ("error", "string", "one"),
        5: ("depth", "uint32", "one"),
        6: ("engine_id", "string", "one"),
    },
    # Disaggregated prefill/decode serving (serving/disagg.py): a live
    # sequence lifted off a prefill engine for cross-process KV transfer.
    # ``kv`` / ``draft_kv`` carry the serialize_kv page payloads opaque;
    # the rest reconstructs the host-side sequence state exactly.
    "KvHandoff": {
        1: ("request_id", "string", "one"),
        2: ("token_ids", "uint32", "rep"),
        3: ("prompt_len", "uint32", "one"),
        4: ("seq_len", "uint32", "one"),
        5: ("next_token", "uint32", "one"),
        6: ("emitted_tokens", "uint32", "one"),
        7: ("output_text", "string", "one"),
        8: ("emitted_upto", "uint32", "one"),
        9: ("pending_ids", "uint32", "rep"),
        10: ("max_tokens", "uint32", "one"),
        # double, not float: sampled-path token identity across the
        # handoff requires the params bit-exact, and Python floats are
        # doubles
        11: ("temperature", "double", "one"),
        12: ("top_p", "double", "one"),
        13: ("stop_sequences", "string", "rep"),
        14: ("kv", "bytes", "one"),
        15: ("draft_kv", "bytes", "opt"),
        16: ("source_engine", "string", "one"),
    },
}

_SCALAR_DEFAULT = {
    "string": "",
    "bytes": b"",
    "uint32": 0,
    "uint64": 0,
    "int64": 0,
    "bool": False,
    "float": 0.0,
    "double": 0.0,
}


# -- encode -----------------------------------------------------------------


def _enc_scalar(ftype: str, value) -> Tuple[int, bytes]:
    """Returns (wire_type, payload bytes without the key)."""
    if ftype == "string":
        data = str(value).encode("utf-8")
        return _LEN, _enc_varint(len(data)) + data
    if ftype == "bytes":
        data = bytes(value)
        return _LEN, _enc_varint(len(data)) + data
    if ftype in ("uint32", "uint64", "int64"):
        return _VARINT, _enc_varint(int(value))
    if ftype == "bool":
        return _VARINT, _enc_varint(1 if value else 0)
    if ftype == "float":
        return _FIXED32, struct.pack("<f", float(value))
    if ftype == "double":
        return _FIXED64, struct.pack("<d", float(value))
    if ftype.startswith("enum:"):
        num = _ENUM_TO_NUM[ftype[5:]].get(value, 0)
        return _VARINT, _enc_varint(num)
    raise ValueError(f"not a scalar type: {ftype}")


def encode(msg: str, obj: Dict[str, Any]) -> bytes:
    if msg == "TokenEvent":
        return _encode_token_event(obj)
    return _encode_fields(msg, obj)


def _encode_fields(msg: str, obj: Dict[str, Any]) -> bytes:
    fields = MESSAGES[msg]
    out = bytearray()
    for num in sorted(fields):
        name, ftype, card = fields[num]
        if name not in obj:
            continue
        value = obj[name]
        if card == "rep":
            items = value or []
            if ftype.startswith("msg:"):
                sub = ftype[4:]
                for item in items:
                    data = encode(sub, item)
                    out += _key(num, _LEN) + _enc_varint(len(data)) + data
            elif ftype in ("float", "double", "uint32", "uint64", "int64",
                           "bool") or ftype.startswith("enum:"):
                # packed (proto3 default for scalars)
                packed = bytearray()
                for item in items:
                    _, payload = _enc_scalar(ftype, item)
                    packed += payload
                if packed:
                    out += (_key(num, _LEN)
                            + _enc_varint(len(packed)) + bytes(packed))
            else:  # strings/bytes are never packed
                for item in items:
                    wire, payload = _enc_scalar(ftype, item)
                    out += _key(num, wire) + payload
            continue
        if value is None:
            continue
        if ftype.startswith("msg:"):
            data = _encode_fields(ftype[4:], value)
            out += _key(num, _LEN) + _enc_varint(len(data)) + data
            continue
        if card == "one":
            # implicit presence: zero values stay off the wire
            if ftype.startswith("enum:"):
                if _ENUM_TO_NUM[ftype[5:]].get(value, 0) == 0:
                    continue
            elif value == _SCALAR_DEFAULT.get(ftype):
                continue
        wire, payload = _enc_scalar(ftype, value)
        out += _key(num, wire) + payload
    return bytes(out)


def _encode_token_event(obj: Dict[str, Any]) -> bytes:
    kind = obj.get("type")
    if kind == "token":
        inner = {"token": obj.get("token", ""),
                 "index": obj.get("index", 0)}
        if obj.get("logprob") is not None:
            inner["logprob"] = obj["logprob"]
        return _encode_fields("TokenEvent", {"token": inner})
    if kind == "done":
        return _encode_fields("TokenEvent", {"done": {
            "finish_reason": obj.get("finish_reason"),
            "usage": obj.get("usage"),
        }})
    if kind == "error":
        return _encode_fields("TokenEvent", {"error": {
            "messages": obj.get("messages", ""),
            "code": obj.get("code", ""),
        }})
    raise ValueError(f"unknown TokenEvent type: {kind!r}")


# -- decode -----------------------------------------------------------------


def _check_len(data: bytes, pos: int, length: int) -> None:
    # slicing past the buffer would silently shorten the field (a
    # truncated frame decoding to a plausible-but-wrong payload)
    if pos + length > len(data):
        raise ValueError("truncated length-delimited field")


def _skip(wire: int, data: bytes, pos: int) -> int:
    if wire == _VARINT:
        _, pos = _dec_varint(data, pos)
        return pos
    if wire == _FIXED64:
        return pos + 8
    if wire == _FIXED32:
        return pos + 4
    if wire == _LEN:
        length, pos = _dec_varint(data, pos)
        _check_len(data, pos, length)
        return pos + length
    raise ValueError(f"unsupported wire type {wire}")


def _dec_scalar(ftype: str, wire: int, data: bytes, pos: int):
    if ftype == "string":
        if wire != _LEN:
            raise ValueError("string field must be length-delimited")
        length, pos = _dec_varint(data, pos)
        _check_len(data, pos, length)
        return data[pos:pos + length].decode("utf-8"), pos + length
    if ftype == "bytes":
        if wire != _LEN:
            raise ValueError("bytes field must be length-delimited")
        length, pos = _dec_varint(data, pos)
        _check_len(data, pos, length)
        return bytes(data[pos:pos + length]), pos + length
    if ftype in ("uint32", "uint64", "int64"):
        v, pos = _dec_varint(data, pos)
        return (_signed64(v) if ftype == "int64" else v), pos
    if ftype == "bool":
        v, pos = _dec_varint(data, pos)
        return bool(v), pos
    if ftype == "float":
        return struct.unpack("<f", data[pos:pos + 4])[0], pos + 4
    if ftype == "double":
        return struct.unpack("<d", data[pos:pos + 8])[0], pos + 8
    if ftype.startswith("enum:"):
        v, pos = _dec_varint(data, pos)
        return ENUMS[ftype[5:]].get(v), pos
    raise ValueError(f"not a scalar type: {ftype}")


def decode(msg: str, data: bytes) -> Dict[str, Any]:
    if msg == "TokenEvent":
        return _decode_token_event(data)
    fields = MESSAGES[msg]
    obj: Dict[str, Any] = {}
    # proto3 defaults so decoded dicts are key-identical to the JSON wire
    for num in sorted(fields):
        name, ftype, card = fields[num]
        if card == "rep":
            obj[name] = []
        elif card == "one":
            if ftype.startswith("msg:"):
                continue
            obj[name] = (None if ftype.startswith("enum:")
                         else _SCALAR_DEFAULT[ftype])
    pos = 0
    while pos < len(data):
        tag, pos = _dec_varint(data, pos)
        num, wire = tag >> 3, tag & 7
        entry = fields.get(num)
        if entry is None:
            pos = _skip(wire, data, pos)
            continue
        name, ftype, card = entry
        if ftype.startswith("msg:"):
            if wire != _LEN:
                raise ValueError(f"message field {name} wire type {wire}")
            length, pos = _dec_varint(data, pos)
            _check_len(data, pos, length)
            sub = decode(ftype[4:], data[pos:pos + length])
            pos += length
            if card == "rep":
                obj[name].append(sub)
            else:
                obj[name] = sub
            continue
        if card == "rep" and wire == _LEN and ftype in (
            "uint32", "uint64", "int64", "bool", "float", "double"
        ) or (card == "rep" and wire == _LEN
              and ftype.startswith("enum:")):
            # packed scalars
            length, pos = _dec_varint(data, pos)
            end = pos + length
            while pos < end:
                v, pos = _dec_scalar(ftype, _wire_for(ftype), data, pos)
                obj[name].append(v)
            continue
        v, pos = _dec_scalar(ftype, wire, data, pos)
        if card == "rep":
            obj[name].append(v)
        else:
            obj[name] = v
    return obj


def _wire_for(ftype: str) -> int:
    if ftype == "float":
        return _FIXED32
    if ftype == "double":
        return _FIXED64
    return _VARINT


def _decode_token_event(data: bytes) -> Dict[str, Any]:
    # decode via the oneof table, then flatten to the tagged-union JSON
    fields = MESSAGES["TokenEvent"]
    obj: Dict[str, Any] = {}
    pos = 0
    while pos < len(data):
        tag, pos = _dec_varint(data, pos)
        num, wire = tag >> 3, tag & 7
        entry = fields.get(num)
        if entry is None:
            pos = _skip(wire, data, pos)
            continue
        name, ftype, _ = entry
        length, pos = _dec_varint(data, pos)
        _check_len(data, pos, length)
        obj[name] = decode(ftype[4:], data[pos:pos + length])
        pos += length
    if "token" in obj:
        out = {"type": "token", "token": obj["token"]["token"],
               "index": obj["token"]["index"]}
        if "logprob" in obj["token"]:
            out["logprob"] = obj["token"]["logprob"]
        return out
    if "done" in obj:
        return {"type": "done",
                "finish_reason": obj["done"]["finish_reason"],
                "usage": obj["done"].get(
                    "usage",
                    {"prompt_tokens": 0, "completion_tokens": 0,
                     "total_tokens": 0},
                )}
    if "error" in obj:
        return {"type": "error", "messages": obj["error"]["messages"],
                "code": obj["error"]["code"]}
    raise ValueError("TokenEvent with no oneof member set")
