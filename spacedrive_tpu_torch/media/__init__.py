"""Media of the port: the image decoders the near-dup job's pHash reads, and
the media plane's first half (EXIF rows, thumbnails, the thumbnailer and the
media processor job)."""
