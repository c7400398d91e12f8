"""The least time of a forward's Poseidon permutations (the circuit's count a
proof, yardstick.perms_per_proof, times the batch, at W = 19,180 int32
instructions a permutation on 132 SMs x 64 lanes x 1980 MHz) over the
device's busy time a forward in the profiled span, in %. It bounds the
hashing alone and counts no kernel by name."""

from yardstick import SECONDS_A_PERMUTATION


def read(obs):
    span = obs["span"]
    if not span or span["busy_s_a_forward"] <= 0:
        return None
    least = obs["perms_per_proof"] * obs["batch"] * SECONDS_A_PERMUTATION
    return 100.0 * least / span["busy_s_a_forward"]
