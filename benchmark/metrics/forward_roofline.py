"""The least time of a forward's hashing (the circuit's counts a proof, the
reference's Poseidon permutations `perms_per_proof` at W = 19,180 and its
Keccak-f[1600] calls `keccak_per_proof` at K = 4,133 int32 instructions
each, yardstick.py, times the batch, on 132 SMs x 64 lanes x 1980 MHz) over
the device's busy time a forward in the profiled span, in %. It bounds the
hashing alone and counts no kernel by name."""

from yardstick import SECONDS_A_KECCAK, SECONDS_A_PERMUTATION


def read(obs):
    span = obs["span"]
    if not span or span["busy_s_a_forward"] <= 0:
        return None
    least = obs["perms_per_proof"] * obs["batch"] * SECONDS_A_PERMUTATION
    least += obs["keccak_per_proof"] * obs["batch"] * SECONDS_A_KECCAK
    return 100.0 * least / span["busy_s_a_forward"]
