"""messages_per_job: the paper's communication metric, BSPStats'
total_messages summed over the window's jobs, a job."""


def read(rec):
    if not rec.jobs:
        return None
    return rec.messages / rec.jobs
