"""Process start to the first timed dispatch: library found or built, proofs
read, inputs flattened, batches made on the card, verifier built, warm-up."""


def read(obs):
    return obs["setup_s"]
