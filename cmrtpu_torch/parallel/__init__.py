"""Host-to-device data movement (counterparts of ``cmrtpu.parallel``): the
host producer thread and the put-ahead copy on a side stream."""
