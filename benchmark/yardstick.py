"""The yardstick of the hashing work: the least time the H100 can take for a
Poseidon permutation. The count of permutations a proof is the plain
reference's own (reference.judge's `permutations` on an honest proof: the
transcript, the public inputs' hash and each query's Merkle openings, a
function of the circuit's shape alone). The cost of a permutation is fixed
here and never read from the card: W = 19,180 32-bit integer instructions
(118 S-boxes x 64 + 360 MDS rows x 32 + 60 + 48), at 132 SMs x 64 int32
lanes x 1980 MHz (the H100 SXM's maximum SM clock) = 1.6727e13 instructions
a second.
"""

W_INSTRUCTIONS = 19_180
INT32_RATE = 132 * 64 * 1980e6
SECONDS_A_PERMUTATION = W_INSTRUCTIONS / INT32_RATE  # 1.1466e-9
