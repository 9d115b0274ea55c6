from kungfu_tpu_torch.store.versioned import BlobStore, VersionedStore

__all__ = ["BlobStore", "VersionedStore"]
