"""The port's p2p plane: identities, the encrypted tunnel, the declared
wire contracts, spaceblock transfers, discovery and the sync mesh.

Port of ``spacedrive_tpu/p2p/`` on the port's own cryptography
(``_crypto``) and msgpack codec. Import the modules directly
(``p2p.manager``, ``p2p.wire``): ``sync`` imports ``p2p.wire`` alone.
"""
