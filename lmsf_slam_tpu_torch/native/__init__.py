from .bindings import (  # noqa: F401
    NativeRing,
    ScanPrefetcher,
    native_available,
    read_f32,
    read_pcd,
    write_pcd,
)
