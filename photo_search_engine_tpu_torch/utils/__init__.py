"""Host-side helpers: image decode/EXIF (stays on CPU in any build,
SURVEY.md §2 native obligations) and cross-OS path handling."""
