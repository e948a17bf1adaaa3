"""The port's sync write path: HLC stamps, CRDT ops, the op log and its
page-level blobs. Import the modules directly (``sync.manager``,
``sync.crdt``); the store imports ``sync.crdt`` for its ids."""
