"""The streaming batch loop: one circuit shape (StreamVerifier) or many
(BucketedStreamVerifier) through TorchVerifier on one device.

Sharding a batch over several devices (the `mesh=` argument of both classes)
is not ported yet: ROADMAP.md, Queue 1 item 10.
"""

from .stream import BucketedStreamVerifier, StreamVerifier, template_key  # noqa: F401
