"""PartSet: a block split into 64-KiB parts with Merkle proofs for gossip
and storage (reference: types/part_set.go:178,198,298; a copy of
cometbft_tpu/types/part_set.py).  The proofs are made and checked on the
host, as in the JAX package."""

from __future__ import annotations

from ..crypto import hash as tmhash
from ..crypto import merkle
from ..wire import types as pb
from .block import PartSetHeader

BLOCK_PART_SIZE_BYTES = 65536


class Part:
    __slots__ = ("index", "bytes", "proof")

    def __init__(self, index: int, data: bytes, proof: merkle.Proof):
        self.index = index
        self.bytes = data
        self.proof = proof

    def validate_basic(self) -> None:
        if self.index < 0:
            raise ValueError("negative Index")
        if len(self.bytes) > BLOCK_PART_SIZE_BYTES:
            raise ValueError("part bytes too big")
        if len(self.proof.leaf_hash) != tmhash.SIZE:
            raise ValueError("bad proof leaf hash")

    def to_proto(self) -> pb.Part:
        return pb.Part(
            index=self.index,
            bytes=self.bytes,
            proof=pb.Proof(
                total=self.proof.total,
                index=self.proof.index,
                leaf_hash=self.proof.leaf_hash,
                aunts=list(self.proof.aunts),
            ),
        )

    @classmethod
    def from_proto(cls, m: pb.Part) -> "Part":
        pf = m.proof or pb.Proof()
        return cls(
            index=m.index,
            data=m.bytes,
            proof=merkle.Proof(
                total=pf.total,
                index=pf.index,
                leaf_hash=pf.leaf_hash,
                aunts=list(pf.aunts),
            ),
        )


class PartSet:
    """A block's parts, either built from data (proposer side) or filled
    incrementally from gossip (receiver side, part_set.go:298 AddPart)."""

    def __init__(self, header: PartSetHeader):
        self.header = header
        self.parts: list[Part | None] = [None] * header.total
        self.count = 0
        self.byte_size = 0

    @classmethod
    def from_data(cls, data: bytes, part_size: int = BLOCK_PART_SIZE_BYTES) -> "PartSet":
        """Split data into parts with inclusion proofs (part_set.go:178)."""
        total = max(1, (len(data) + part_size - 1) // part_size)
        chunks = [data[i * part_size : (i + 1) * part_size] for i in range(total)]
        root, proofs = merkle.proofs_from_byte_slices(chunks)
        ps = cls(PartSetHeader(total=total, hash=root))
        for i, chunk in enumerate(chunks):
            ps.parts[i] = Part(index=i, data=chunk, proof=proofs[i])
        ps.count = total
        ps.byte_size = len(data)
        return ps

    def add_part(self, part: Part) -> bool:
        """Verify the part's proof against the header and add it
        (part_set.go:298)."""
        if part.index >= self.header.total:
            raise ValueError("part index out of bounds")
        if self.parts[part.index] is not None:
            return False
        part.validate_basic()
        part.proof.verify(self.header.hash, part.bytes)
        self.parts[part.index] = part
        self.count += 1
        self.byte_size += len(part.bytes)
        return True

    def is_complete(self) -> bool:
        return self.count == self.header.total

    def get_part(self, index: int) -> Part | None:
        return self.parts[index]

    def assemble(self) -> bytes:
        if not self.is_complete():
            raise ValueError("part set incomplete")
        return b"".join(p.bytes for p in self.parts)

    def bit_array(self) -> list[bool]:
        return [p is not None for p in self.parts]
