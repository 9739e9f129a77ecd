"""Pluggable upload codecs: compression of client uploads on the wire
(port of `repro.core.codecs`; DESIGN.md §12).

A `Codec` transforms each client upload between local training and
aggregation. The driver seam is *corrupt -> encode -> decode ->
aggregate*: the wire carries the (possibly corrupted) encoded update,
and defenses always see dequantized dense coordinates. The fused
dequantize-and-aggregate kernel (`kernels/comm_agg.py`) is not on this
path, as in the reference: rounds decode, then aggregate through
`fedavg_agg`.

Codecs register by name (`register_codec` / `get_codec`), declare the
defenses they compose with in a class-level `defenses` tuple, and reach
every engine through one round trip, `scan_encode_decode`, so the loop
and vectorized engines share the same codec math.

Randomness (DESIGN.md §4, codec salt): stochastic rounding is keyed by
(seed, event, absolute client id). `jax.random` cannot be reproduced in
torch, so the uniforms come from one seam, `rounding_uniforms`: a CPU
`torch.Generator` seeded from `SeedSequence([seed ^ salt, event,
client])`, moved to the device, so the CPU and the card round with the
same uniforms. The parity tests replace it with the reference's draws;
given the same row and the same uniforms, `q` and `scale` are bitwise
the reference's (same operations: `/ scale`, `floor`, a strict `<`,
clip, cast).

The fused executor (DESIGN.md §10) draws each round's randomness before
the run through the same seam (`Codec.draws`) and passes the (k, N)
tensor of draws in place of the keys, so no round draws on the host.

Top-k selects by a stable descending sort of |delta|, so ties go to the
lower index as under `jax.lax.top_k`; `torch.topk` promises no order.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.fl_types import DEFENSES
from repro_torch.kernels import ops
from repro_torch.tree import tree_map

# Codec-private salt for the (seed, event, client) key derivation,
# distinct from attacks._ATTACK_SALT so quantization noise and attack
# noise are independent streams of the same run seed.
_CODEC_SALT = 0xC0DE_C5ED

UploadKey = Tuple[int, int, int]


def upload_keys(seed: int, event: int, client_ids) -> List[UploadKey]:
    """(seed, event, client id) -> one key per participant, from absolute
    ids (participation-order independent)."""
    return [(int(seed), int(event), int(c) & 0x7FFFFFFF)
            for c in np.asarray(client_ids).reshape(-1)]


def rounding_uniforms(seed: int, event: int, client_id: int, n: int,
                      device) -> torch.Tensor:
    """U[0, 1) float32 rounding noise for one client's upload at one
    event: drawn on a CPU generator seeded from (seed ^ salt, event,
    client id), then moved to `device`."""
    ss = np.random.SeedSequence([(int(seed) & 0xFFFFFFFF) ^ _CODEC_SALT,
                                 int(event), int(client_id) & 0x7FFFFFFF])
    g = torch.Generator(device="cpu")
    g.manual_seed(int(ss.generate_state(1, np.uint64)[0]))
    return torch.rand((int(n),), generator=g,
                      dtype=torch.float32).to(device)


def _uniforms(keys: Sequence[UploadKey], n: int, device) -> torch.Tensor:
    """(k, n) rounding uniforms, one row per key."""
    return torch.stack([rounding_uniforms(*key, n, device) for key in keys])


class Codec:
    """Lifecycle protocol for an upload codec.

    Subclasses set `name`, declare `defenses` (validated at simulation
    build, like `Strategy.defenses`) and implement `encode` / `decode` /
    `bytes_on_wire`. `encode` and `decode` operate on the raveled (k, N)
    float32 upload matrix of one aggregation event's participants.

    Class attributes:
      stateful       — per-client state (error-feedback residuals) across
                       rounds.
      needs_bases    — `encode` is relative to each participant's base
                       (pre-training) parameters.
      supports_fused — the codec composes with the fused executor: its
                       randomness, if any, comes from `draws`, which the
                       executor hoists before the run.
    """

    name: str = ""
    defenses: Tuple[str, ...] = ("none",)
    stateful: bool = False
    needs_bases: bool = False
    supports_fused: bool = True

    def __init__(self, fl):
        self.fl = fl

    def validate(self, fl) -> None:
        """Raise if the codec cannot run under this config."""
        if fl.defense not in self.defenses:
            raise ValueError(
                f"codec {self.name!r} does not support defense "
                f"{fl.defense!r}; declared: {self.defenses}")

    # -- lifecycle ----------------------------------------------------------
    def init_state(self, num_clients: int, dim: int, device="cpu") -> Dict:
        """Per-client codec state (empty for stateless codecs)."""
        return {}

    def encode(self, mat, keys, *, base=None, rows=None):
        """(k, N) uploads -> (payload, new per-client state rows). `keys`
        are the participants' `upload_keys`; `base` the (k, N) raveled
        base parameters when `needs_bases`; `rows` the participants'
        state rows when `stateful`."""
        raise NotImplementedError

    def decode(self, payload, *, base=None):
        """Payload -> dequantized dense (k, N) float32 uploads."""
        raise NotImplementedError

    def bytes_on_wire(self, dim: int) -> int:
        """Uplink bytes one client pays to ship one encoded upload."""
        raise NotImplementedError

    def draws(self, keys, n: int):
        """The (k, n) host tensor of random draws `encode` consumes for
        `keys`, or None for a deterministic codec. `encode` accepts this
        tensor (on the device) in place of the keys."""
        return None

    def scan_encode_decode(self, mat, keys, *, base=None, rows=None):
        """One encode -> decode round trip: (decoded, new rows). The one
        entry point of every engine, so codec math is shared."""
        payload, new_rows = self.encode(mat, keys, base=base, rows=rows)
        return self.decode(payload, base=base), new_rows


CODEC_REGISTRY: Dict[str, type] = {}
CODEC_REGISTRY_VERSION = 1


def register_codec(cls):
    """Class decorator: register a Codec subclass under `cls.name`."""
    name = getattr(cls, "name", "")
    if not name or not isinstance(name, str):
        raise ValueError("codec class must define a non-empty string `name`")
    if name in CODEC_REGISTRY:
        raise ValueError(f"codec {name!r} is already registered")
    CODEC_REGISTRY[name] = cls
    return cls


def get_codec(name: str) -> type:
    """Look up a registered codec class by name."""
    try:
        return CODEC_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown codec {name!r}; registered: {codec_names()}") from None


def codec_names():
    return sorted(CODEC_REGISTRY)


@register_codec
class NoneCodec(Codec):
    """Dense float32 uploads — the identity wire format. The driver
    short-circuits on the name and never calls it: `codec="none"` runs
    the pre-codec path."""

    name = "none"
    defenses = DEFENSES

    def encode(self, mat, keys, *, base=None, rows=None):
        return mat, rows

    def decode(self, payload, *, base=None):
        return payload

    def bytes_on_wire(self, dim: int) -> int:
        return 4 * dim


@register_codec
class TopKCodec(Codec):
    """Magnitude top-k sparsification with error-feedback residuals.

    Encodes the training delta (upload - base) plus the client's
    accumulated residual, ships the k largest-|.| coordinates as
    (value, index) pairs and banks the rest back into the residual."""

    name = "topk"
    defenses = DEFENSES
    stateful = True
    needs_bases = True

    def __init__(self, fl):
        super().__init__(fl)
        self.frac = float(fl.topk_frac)

    def _k(self, dim: int) -> int:
        return max(1, min(dim, int(np.ceil(self.frac * dim))))

    def init_state(self, num_clients: int, dim: int, device="cpu") -> Dict:
        return {"resid": torch.zeros((num_clients, dim), dtype=torch.float32,
                                     device=device)}

    def encode(self, mat, keys, *, base=None, rows=None):
        delta = mat - base + rows["resid"]
        k = self._k(delta.shape[1])
        # stable descending sort: ties keep the lower index first, the
        # order jax.lax.top_k returns
        idx = torch.sort(delta.abs(), dim=1, descending=True,
                         stable=True).indices[:, :k]
        vals = torch.gather(delta, 1, idx)
        new_rows = {"resid": delta.scatter(1, idx, 0.0)}
        return {"values": vals, "idx": idx}, new_rows

    def decode(self, payload, *, base=None):
        sparse = torch.zeros_like(base).scatter(1, payload["idx"],
                                                payload["values"])
        return base + sparse

    def bytes_on_wire(self, dim: int) -> int:
        # 4-byte float value + 4-byte int32 index per kept coordinate
        return 8 * self._k(dim)


@register_codec
class QSGDCodec(Codec):
    """Unbiased stochastic quantization of the raw upload.

    `quant_bits=8`: per-client max-|.| scaling to int8 levels with
    stochastic rounding (E[q * scale] == value), one float32 scale per
    client on the wire. `quant_bits=16`: stochastic rounding to bfloat16
    between the value's two nearest bf16 neighbours."""

    name = "qsgd"
    defenses = DEFENSES

    def __init__(self, fl):
        super().__init__(fl)
        self.bits = int(fl.quant_bits)

    def draws(self, keys, n: int):
        return _uniforms(keys, n, "cpu")

    def encode(self, mat, keys, *, base=None, rows=None):
        u = (keys if isinstance(keys, torch.Tensor)
             else _uniforms(keys, mat.shape[1], mat.device))
        if self.bits == 8:
            q, scale = self._enc_int8(mat, u)
            return {"q": q, "scale": scale}, rows
        return {"q": self._enc_bf16(mat, u)}, rows

    @staticmethod
    def _enc_int8(mat, u):
        """(k, N) rows, (k, N) uniforms -> int8 levels, (k,) scales."""
        scale = torch.clamp(mat.abs().amax(dim=1), min=1e-12) / 127.0
        m = mat / scale[:, None]
        low = torch.floor(m)
        q = low + (u < (m - low)).float()
        return torch.clamp(q, -127.0, 127.0).to(torch.int8), scale

    @staticmethod
    def _enc_bf16(mat, u):
        """(k, N) rows, (k, N) uniforms -> bfloat16, rounded up to the
        upper bf16 neighbour with probability proportional to the
        distance. The bit arithmetic runs in int64 and wraps to 32 bits,
        as the reference's uint32 does."""
        trunc = mat.contiguous().view(torch.int32).to(torch.int64) \
            & 0xFFFF0000
        up = (trunc + 0x10000) & 0xFFFFFFFF

        def as_f32(b):
            return (torch.where(b >= 2 ** 31, b - 2 ** 32, b)
                    .to(torch.int32).view(torch.float32))

        a, b = as_f32(trunc), as_f32(up)
        lo, hi = torch.minimum(a, b), torch.maximum(a, b)
        span = hi - lo
        pos = span > 0
        p = torch.where(pos, (mat - lo) / torch.where(pos, span, 1.0),
                        torch.zeros_like(mat))
        return torch.where(u < p, hi, lo).to(torch.bfloat16)

    def decode(self, payload, *, base=None):
        if "scale" in payload:
            return payload["q"].float() * payload["scale"][:, None]
        return payload["q"].float()

    def bytes_on_wire(self, dim: int) -> int:
        if self.bits == 8:
            return dim + 4  # int8 per coordinate + one float32 scale
        return 2 * dim


def roundtrip_tree(codec: Codec, tree, keys, base_tree=None):
    """Encode -> decode one (unstacked) upload tree — the CFL seam: the
    sequential strategy merges one visit at a time, so the tree is
    raveled to a (1, N) row, sent through the codec and unraveled. Only
    stateless codecs reach here (validated at simulation build)."""
    row = ops.stacked_ravel(tree_map(lambda leaf: leaf[None], tree))
    base = None
    if codec.needs_bases:
        base = ops.stacked_ravel(tree_map(lambda leaf: leaf[None],
                                          base_tree))
    dec, _ = codec.scan_encode_decode(row, keys, base=base, rows=None)
    return ops.tree_unravel(tree_map(lambda leaf: leaf[None], tree), dec[0])
