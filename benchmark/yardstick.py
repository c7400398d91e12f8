"""The yardstick of the hashing work: the least time the H100 can take for a
Poseidon permutation and for a Keccak-f[1600]. The counts a proof are the
plain reference's own (reference.judge's `permutations` and
`keccak_permutations` on an honest proof: the transcript, the public inputs'
hash and each query's Merkle openings, a function of the circuit's shape and
its hasher alone). The cost of each is fixed here and never read from the
card, in 32-bit integer instructions at 132 SMs x 64 int32 lanes x 1980 MHz
(the H100 SXM's maximum SM clock) = 1.6727e13 instructions a second:

- W = 19,180 a Poseidon permutation (118 S-boxes x 64 + 360 MDS rows x 32 +
  60 + 48).
- K = 4,133 a Keccak-f[1600] call, its 64-bit lanes as 32-bit halves, a
  logic function of 3 inputs one LOP3, a 64-bit rotation two funnel shifts
  (none of rho's offsets is 0 mod 32 but lane 0's). A round on an arbitrary
  state is 178 + iota: theta 80 (the columns' parities 5 x 2 x 2, their
  rotations by 1 5 x 2, each lane's update by its two columns one LOP3 a
  half, 50), rho 48 (24 lanes x 2; pi moves registers), chi 50 (one LOP3 a
  half), iota the round constant's non-zero halves (37 over 24 rounds). The
  first and last rounds are counted at the least any call of Plonky2's Keccak
  hashing needs: round 1 on its sparsest block (a 32-byte input: 8 halves of
  data, 2 of padding, the rest zero) 126: theta 27 (1 parity, 8 for the
  rotations of the 4 variable columns, 8 for the 5 columns' D, 10 for the 6
  non-zero lanes' updates), rho 48, chi 50, iota 1; round 24 for the 25
  bytes a digest keeps 57: theta 40 (every parity and rotation, the 5
  diagonal lanes that chi's row 0 reads), rho 8, chi 7 (lanes 0-2 and lane
  3's low half), iota 2. So K = 126 + 22 x 178 + 34 (iota, rounds 2-23)
  + 57. Absorbing a block (the XOR of its lanes) is not counted. Bit
  interleaving saves 6 a round (a rotation by 1 becomes one shift), but
  converting a lane to it and back takes ~30 instructions each way (four
  delta swaps a half), and a call's at least 4 lanes in and 3 out cost more
  than the 6 x 24 it saves.
"""

W_INSTRUCTIONS = 19_180
K_INSTRUCTIONS = 4_133
INT32_RATE = 132 * 64 * 1980e6
SECONDS_A_PERMUTATION = W_INSTRUCTIONS / INT32_RATE  # 1.1466e-9
SECONDS_A_KECCAK = K_INSTRUCTIONS / INT32_RATE  # 2.4708e-10
