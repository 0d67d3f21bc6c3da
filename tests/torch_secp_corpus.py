"""A seeded adversarial secp256k1 corpus for the port's tests, signed with
the port's host signers (RFC 6979: byte-identical to the JAX package's).

Valid Cosmos, Ethereum and ecrecover rows interleaved with every invalid
class of tests/test_secp_ops.py:23-96 and the firehose storm pool, plus
the ecrecover edges (wrong address, wrong v, v = 2, tampered message,
an r with no square root), and a valid row that takes the x == r + n
branch of the Cosmos verdict."""

from __future__ import annotations

from cometbft_tpu_torch.crypto import secp256k1 as host
from cometbft_tpu_torch.crypto import secp256k1eth as heth

P, N = host.P, host.N


def no_sqrt_x(start: int = 5) -> int:
    """The least x >= start with x^3 + 7 a non-residue mod p."""
    x = start
    while True:
        y2 = (pow(x, 3, P) + host.B) % P
        if pow(y2, (P + 1) // 4, P) ** 2 % P != y2:
            return x
        x += 1


def wraparound_row() -> tuple[bytes, bytes, bytes]:
    """A VALID Cosmos row whose R' has n <= x < p, so the verdict takes
    the x == r + n branch (an honest signer hits it with probability
    ~2^-128): R is lifted from the least such x, the key Q solved from
    R = u1 G + u2 Q for a chosen s and the message's e."""
    import hashlib

    x = N + 1
    while True:
        y2 = (pow(x, 3, P) + host.B) % P
        y = pow(y2, (P + 1) // 4, P)
        if y * y % P == y2:
            break
        x += 1
    r = x - N
    msg = b"wraparound"
    e = int.from_bytes(hashlib.sha256(msg).digest(), "big") % N
    s = 0x1234567890ABCDEF1234567890ABCDEF
    w = pow(s, N - 2, N)
    u1, u2 = e * w % N, r * w % N
    g1 = host._mul(u1, host.G)
    q = host._mul(pow(u2, N - 2, N), host._add((x, y), (g1[0], (P - g1[1]) % P)))
    return host._compress(q), msg, r.to_bytes(32, "big") + s.to_bytes(32, "big")


def corpus(tag: bytes = b"") -> list[tuple[bytes, bytes, bytes, str]]:
    """(pub, msg, sig, label) rows; ``tag`` varies keys and messages."""
    out = []

    def cosmos(seed, msg=b"ok", tamper=None, label="cosmos"):
        sk = host.PrivKey.from_seed(tag + seed)
        pub, msg, sig = sk.pub_key().data, tag + msg, sk.sign(tag + msg)
        if tamper:
            pub, msg, sig = tamper(pub, msg, sig)
        out.append((pub, msg, sig, label))

    def ether(seed, msg=b"ok-eth", tamper=None, label="eth"):
        sk = heth.PrivKey.from_seed(tag + seed)
        pub, msg, sig = sk.pub_key().data, tag + msg, sk.sign(tag + msg)
        if tamper:
            pub, msg, sig = tamper(pub, msg, sig)
        out.append((pub, msg, sig, label))

    def recover(seed, msg=b"ok-rec", tamper=None, label="ecrecover"):
        sk = heth.RecoverPrivKey.from_seed(tag + seed)
        pub, msg, sig = sk.pub_key().data, tag + msg, sk.sign(tag + msg)
        if tamper:
            pub, msg, sig = tamper(pub, msg, sig)
        out.append((pub, msg, sig, label))

    for i in range(4):
        cosmos(b"valid-%d" % i, b"cosmos message %d" % i)
        ether(b"valid-eth-%d" % i, b"eth message %d" % i)
        recover(b"valid-rec-%d" % i, b"recover message %d" % i)

    def high_s(p, m, s):
        sv = int.from_bytes(s[32:64], "big")
        return p, m, s[:32] + (N - sv).to_bytes(32, "big") + s[64:]

    cosmos(b"t-sig", tamper=lambda p, m, s: (p, m, s[:40] + bytes([s[40] ^ 1]) + s[41:]), label="tampered sig")
    cosmos(b"t-msg", tamper=lambda p, m, s: (p, m + b"!", s), label="tampered msg")
    cosmos(b"t-hs", tamper=high_s, label="high s")
    cosmos(b"t-r0", tamper=lambda p, m, s: (p, m, b"\x00" * 32 + s[32:]), label="r = 0")
    cosmos(b"t-s0", tamper=lambda p, m, s: (p, m, s[:32] + b"\x00" * 32), label="s = 0")
    cosmos(b"t-rn", tamper=lambda p, m, s: (p, m, N.to_bytes(32, "big") + s[32:]), label="r >= n")
    cosmos(b"t-sn", tamper=lambda p, m, s: (p, m, s[:32] + (N + 1).to_bytes(32, "big")), label="s >= n")
    cosmos(b"t-wk", tamper=lambda p, m, s: (host.PrivKey.from_seed(b"other").pub_key().data, m, s),
           label="wrong key")
    cosmos(b"t-pfx", tamper=lambda p, m, s: (b"\x05" + p[1:], m, s), label="bad prefix")
    cosmos(b"t-xp", tamper=lambda p, m, s: (b"\x02" + P.to_bytes(32, "big"), m, s), label="x >= p")
    x = no_sqrt_x()
    cosmos(b"t-oc", tamper=lambda p, m, s: (b"\x02" + x.to_bytes(32, "big"), m, s), label="off-curve x")
    cosmos(b"t-xs", tamper=lambda p, m, s: (p, m, s + b"\x01"), label="cosmos key, eth sig length")
    ether(b"e-v", tamper=lambda p, m, s: (p, m, s[:64] + bytes([s[64] ^ 1])), label="wrong v")
    ether(b"e-v2", tamper=lambda p, m, s: (p, m, s[:64] + b"\x02"), label="v = 2")
    ether(b"e-r", tamper=lambda p, m, s: (p, m, bytes([s[0] ^ 1]) + s[1:]), label="tampered r")
    ether(b"e-pub", tamper=lambda p, m, s: (p[:64] + bytes([p[64] ^ 1]), m, s), label="off-curve eth key")
    ether(b"e-xs", tamper=lambda p, m, s: (p, m, s[:64]), label="eth key, cosmos sig length")
    ether(b"e-hs", tamper=lambda p, m, s: high_s(p, m, s[:64] + bytes([s[64] ^ 1])), label="eth high s")
    recover(b"r-addr", tamper=lambda p, m, s: (b"\x42" * 20, m, s), label="wrong address")
    recover(b"r-v", tamper=lambda p, m, s: (p, m, s[:64] + bytes([s[64] ^ 1])), label="ecrecover wrong v")
    recover(b"r-v2", tamper=lambda p, m, s: (p, m, s[:64] + b"\x02"), label="ecrecover v = 2")
    recover(b"r-msg", tamper=lambda p, m, s: (p, m + b"!", s), label="ecrecover tampered msg")
    recover(b"r-sqrt", tamper=lambda p, m, s: (p, m, x.to_bytes(32, "big") + s[32:]), label="r with no sqrt")
    recover(b"r-hs", tamper=high_s, label="ecrecover high s")
    recover(b"r-xs", tamper=lambda p, m, s: (p, m, s[:64]), label="ecrecover, cosmos sig length")
    out.append(wraparound_row() + ("x == r + n",))
    return out


def infinity_row(tag: bytes = b"") -> tuple[bytes, bytes, bytes]:
    """A Cosmos row whose walk ends at infinity: with the key
    Q = -(e / r) G, u1 G + u2 Q = (e G + r Q) / s = O (the row is false,
    and its final Z of 0 must enter a block's inversion as 1)."""
    import hashlib

    msg = b"infinity " + tag
    e = int.from_bytes(hashlib.sha256(msg).digest(), "big")
    r, s = 0x5A5A5A5A1234567890ABCDEF, 0x0F1E2D3C4B5A69788796A5B4C3D2E1F0
    q = host._mul((-e * pow(r, N - 2, N)) % N, host.G)
    return host._compress(q), msg, r.to_bytes(32, "big") + s.to_bytes(32, "big")


def block_edge_order(good: list, bad: list, inf: int, n: int, rows: int) -> list:
    """n row indices for a block-edge batch of ``rows``-row blocks: valid
    rows round-robin, invalid ones at every block's first and last row
    and at every seventh row; the second block holds one valid row, with
    the infinity row beside it, among invalid ones."""
    order = [good[k % len(good)] for k in range(n)]
    for k in range(n):
        if k % rows in (0, rows - 1) or k % 7 == 3:
            order[k] = bad[k % len(bad)]
    if n >= 2 * rows:
        order[rows : 2 * rows] = [bad[k % len(bad)] for k in range(rows)]
        order[rows + rows // 2], order[rows + rows // 2 + 1] = good[0], inf
    elif n >= 2:
        order[n // 2] = inf
    return order
