"""The plain references, and the primes of the fields they compute in."""

PRIMES = {
    "bn128": 21888242871839275222246405745257275088548364400416034343698204186575808495617,
}
