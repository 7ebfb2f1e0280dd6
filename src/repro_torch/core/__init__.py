"""BAM bitfield masks (own copy of ``repro.core.bam``)."""
