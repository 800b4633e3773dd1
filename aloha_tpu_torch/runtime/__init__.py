"""The accelerator-device model (`device.AlohaDevice`) and the op-list host
runner (`host.HostRunner`)."""
