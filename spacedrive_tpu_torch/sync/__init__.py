"""The port's sync plane: HLC stamps, CRDT ops, the op log and its
page-level blobs, the receive and clone half (``manager``), the ingest
actor (``ingest``) and the clone stream's serving side (``clone_serve``).
Import the modules directly (``sync.manager``, ``sync.crdt``); the store
imports ``sync.crdt`` for its ids."""
