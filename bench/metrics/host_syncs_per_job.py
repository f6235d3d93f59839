"""host_syncs_per_job: the engine's HOST_SYNCS counted over the window's
jobs, a job."""


def read(rec):
    if not rec.jobs:
        return None
    return rec.host_syncs / rec.jobs
