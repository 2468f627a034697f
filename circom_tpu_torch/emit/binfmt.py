"""Binary artifact codecs: .r1cs writer/reader and .wtns writer/reader.

Byte-exact implementations of the snarkjs-compatible formats:

* .r1cs — magic "r1cs", version 1, sections header(1)/constraints(2)/
  wire2label(3)/custom-gates(4,5); linear combinations serialized as
  (count, [wire u32, coeff field_size] ...) with entries sorted by the
  little-endian *byte string* of the wire id — NOT numerically
  (constraint_writers/src/r1cs_writer.rs:49-72: BigInt::to_bytes_le values
  ordered by Vec<u8> Ord).  Reproduced exactly for byte parity.
* .wtns — magic "wtns", version 2, 2 sections: header (n8, prime, nVars)
  and the little-endian long-normal witness dump
  (code_producers/src/c_elements/common/main.cpp:288-335).
"""

import struct


def _le_bytes_min(x: int) -> bytes:
    """BigInt::to_bytes_le minimal representation (0 -> b'\\x00')."""
    if x == 0:
        return b"\x00"
    return x.to_bytes((x.bit_length() + 7) // 8, "little")


def _pad(b: bytes, n: int) -> bytes:
    assert len(b) <= n, "value too wide for field"
    return b + b"\x00" * (n - len(b))


def _lc_block(lc: dict, field_size: int) -> bytes:
    """Linear combination block with the reference's byte-string ordering."""
    out = [struct.pack("<I", len(lc))]
    entries = []
    for wire, coef in lc.items():
        entries.append((_le_bytes_min(wire), coef))
    entries.sort(key=lambda e: e[0])
    for wb, coef in entries:
        out.append(_pad(wb, 4))
        out.append(_pad(_le_bytes_min(coef), field_size))
    return b"".join(out)


def field_size_bytes(p: int) -> int:
    bits = p.bit_length()
    return bits // 8 if bits % 64 == 0 else (bits // 64 + 1) * 8


def write_r1cs(path, p: int, constraints, n_wires, n_pub_out, n_pub_in,
               n_prv_in, n_labels, wire2label=None, custom_gates_used=None,
               custom_gates_applied=None):
    """constraints: iterable of (a, b, c) dicts over wire ids."""
    fs = field_size_bytes(p)
    use_custom = custom_gates_used is not None
    n_sections = 5 if use_custom else 3

    cons_blob = bytearray()
    n_cons = 0
    for (a, b, c) in constraints:
        cons_blob += _lc_block(a, fs)
        cons_blob += _lc_block(b, fs)
        cons_blob += _lc_block(c, fs)
        n_cons += 1

    header_blob = struct.pack("<I", fs) + _pad(_le_bytes_min(p), fs)
    header_blob += struct.pack("<I", n_wires)
    header_blob += struct.pack("<I", n_pub_out)
    header_blob += struct.pack("<I", n_pub_in)
    header_blob += struct.pack("<I", n_prv_in)
    header_blob += struct.pack("<Q", n_labels)
    header_blob += struct.pack("<I", n_cons)

    labels = wire2label if wire2label is not None else range(n_wires)
    wire2label_blob = b"".join(struct.pack("<Q", lab) for lab in labels)

    with open(path, "wb") as f:
        f.write(b"r1cs")
        f.write(struct.pack("<I", 1))
        f.write(struct.pack("<I", n_sections))
        # section order matches the reference writer: constraints are
        # written first (dag/src/r1cs_porting.rs:15-19), then header,
        # then wire2label.
        f.write(struct.pack("<I", 2))
        f.write(struct.pack("<Q", len(cons_blob)))
        f.write(cons_blob)
        f.write(struct.pack("<I", 1))
        f.write(struct.pack("<Q", len(header_blob)))
        f.write(header_blob)
        f.write(struct.pack("<I", 3))
        f.write(struct.pack("<Q", len(wire2label_blob)))
        f.write(wire2label_blob)
        if use_custom:
            blob4 = bytearray(struct.pack("<I", len(custom_gates_used)))
            for (name, params) in custom_gates_used:
                blob4 += name.encode() + b"\x00"
                blob4 += struct.pack("<I", len(params))
                for v in params:
                    blob4 += _pad(_le_bytes_min(v), fs)
            f.write(struct.pack("<I", 4))
            f.write(struct.pack("<Q", len(blob4)))
            f.write(blob4)
            blob5 = bytearray(struct.pack("<I", len(custom_gates_applied)))
            for (idx, signals) in custom_gates_applied:
                blob5 += struct.pack("<I", idx)
                blob5 += struct.pack("<I", len(signals))
                for s in signals:
                    blob5 += struct.pack("<Q", s)
            f.write(struct.pack("<I", 5))
            f.write(struct.pack("<Q", len(blob5)))
            f.write(blob5)


def read_r1cs(path):
    """Parse .r1cs -> dict with header fields and constraint list."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:4] == b"r1cs", "bad magic"
    version, n_sections = struct.unpack_from("<II", data, 4)
    off = 12
    sections = {}
    for _ in range(n_sections):
        sid, = struct.unpack_from("<I", data, off)
        size, = struct.unpack_from("<Q", data, off + 4)
        off += 12
        sections[sid] = (off, size)
        off += size
    ho, hs = sections[1]
    fs, = struct.unpack_from("<I", data, ho)
    p = int.from_bytes(data[ho + 4:ho + 4 + fs], "little")
    pos = ho + 4 + fs
    n_wires, n_pub_out, n_pub_in, n_prv_in = struct.unpack_from(
        "<IIII", data, pos)
    n_labels, = struct.unpack_from("<Q", data, pos + 16)
    n_cons, = struct.unpack_from("<I", data, pos + 24)

    co, cs = sections[2]
    pos = co
    constraints = []
    for _ in range(n_cons):
        lcs = []
        for _ in range(3):
            cnt, = struct.unpack_from("<I", data, pos)
            pos += 4
            lc = {}
            for _ in range(cnt):
                wire, = struct.unpack_from("<I", data, pos)
                coef = int.from_bytes(data[pos + 4:pos + 4 + fs], "little")
                lc[wire] = coef
                pos += 4 + fs
            lcs.append(lc)
        constraints.append(tuple(lcs))
    wo, ws = sections.get(3, (0, 0))
    wire2label = [
        struct.unpack_from("<Q", data, wo + 8 * i)[0] for i in range(ws // 8)
    ]
    return {
        "p": p, "field_size": fs, "n_wires": n_wires,
        "n_pub_out": n_pub_out, "n_pub_in": n_pub_in, "n_prv_in": n_prv_in,
        "n_labels": n_labels, "constraints": constraints,
        "wire2label": wire2label,
    }


def write_wtns(path, p: int, values):
    """Witness values (canonical ints, index order) -> .wtns v2 bytes."""
    bits = p.bit_length()
    n64 = bits // 64 if bits % 64 == 0 else bits // 64 + 1
    n8 = n64 * 8
    with open(path, "wb") as f:
        f.write(b"wtns")
        f.write(struct.pack("<I", 2))
        f.write(struct.pack("<I", 2))
        f.write(struct.pack("<I", 1))
        f.write(struct.pack("<Q", 8 + n8))
        f.write(struct.pack("<I", n8))
        f.write(_pad(_le_bytes_min(p), n8))
        f.write(struct.pack("<I", len(values)))
        f.write(struct.pack("<I", 2))
        f.write(struct.pack("<Q", n8 * len(values)))
        for v in values:
            f.write(_pad(_le_bytes_min(v), n8))


def read_wtns(path):
    with open(path, "rb") as f:
        data = f.read()
    assert data[:4] == b"wtns"
    off = 12
    n8, = struct.unpack_from("<I", data, off + 12)
    p = int.from_bytes(data[off + 16:off + 16 + n8], "little")
    n_vars, = struct.unpack_from("<I", data, off + 16 + n8)
    off2 = off + 20 + n8 + 12
    values = [
        int.from_bytes(data[off2 + i * n8:off2 + (i + 1) * n8], "little")
        for i in range(n_vars)
    ]
    return {"p": p, "n8": n8, "values": values}
