"""One driver a kind of traffic (`kind` in a traffic file), found by
name: drivers/<kind>.py, whose run(...) drives a cell and returns its
`Run`."""
