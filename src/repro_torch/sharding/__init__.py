"""The mesh round's sharding: the client axis's collectives (``spmd``)
and the reference's rule tables and spec logic as pure functions
(``policy``, ``ctx``)."""
