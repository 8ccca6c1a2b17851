"""The runners of the traffic kinds, one file each: ``<kind>.py`` with
``run(ctx) -> harness.Run``, found by the mix's ``kind``
(``manifest.Manifest.runner``)."""
